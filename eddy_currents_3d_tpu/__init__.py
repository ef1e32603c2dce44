"""eddy_currents_3d_tpu — a 3D time-domain eddy-current framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
Fortran solver EC3D (JNSresearcher/eddy_currents_3d): magnetoquasistatic
vector-potential (Ax, Ay, Az) + electric scalar potential (U) on a regular
voxel grid, implicit time stepping, restarted BiCGSTAB, VoxCad `.vxc` input,
runtime math-expression sources (optionally moving), legacy-VTK output.

Design (accelerator-first, not a port):
  * State lives as dense 3-D grid fields; the sparse operator is applied as a
    set of variable-coefficient stencils (DIA layout) — no gathers in the hot
    loop, streaming device memory, and trivially shardable over a device
    mesh.
  * A general sparse library (CSR/COO/ELL containers, SpMV/SpMM) exists
    alongside for tests, interop and irregular matrices.
  * BiCGSTAB with restart is a `lax.while_loop` with fused reductions.
  * Multi-device: z-slab sharding via `jax.sharding.Mesh` + NamedSharding;
    an explicit shard_map tier exchanges the stencil halos.

Reference parity citations use `file:line` into the reference tree
(e.g. ``EC3D.f90:465``) so behavior can be audited side by side.
"""

__version__ = "0.1.0"

from .models.model import Model, DomainSpec, SolverConfig, TranConfig, SourceFunction
from .models.vxc import read_vxc
from .assembly.assemble import assemble_operator
from .solvers.bicgstab import bicgstab_wr
from .sim.simulate import Simulation

__all__ = [
    "Model",
    "DomainSpec",
    "SolverConfig",
    "TranConfig",
    "SourceFunction",
    "read_vxc",
    "assemble_operator",
    "bicgstab_wr",
    "Simulation",
    "__version__",
]
