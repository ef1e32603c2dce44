"""Device-mesh sharding for the stencil system.

The voxel grid is decomposed into z-slabs (and optionally y-columns) over a
``jax.sharding.Mesh``; every field and coefficient array is placed with a
``NamedSharding`` whose last three dims map to (z, y, x-replicated).  Under
``jit`` the XLA SPMD partitioner then turns the stencil shifts along
sharded axes into halo collective-permutes and the solver's dot
products into fused psum all-reduces — the reference has no distribution
at all (single-threaded Fortran), so this layer is pure new capability.

x stays unsharded: it is the contiguous minor dimension, and halo exchange
along it would move strided single elements.
"""

from __future__ import annotations

import warnings

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "grid_sharding", "shard_system", "shard_state", "replicated"]

_warned_replicated: set = set()


def make_mesh(n_z: int | None = None, n_y: int = 1, devices=None) -> Mesh:
    """A (z, y) mesh over the available devices; z gets all devices by
    default."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_z is None:
        n_z = devices.size // n_y
    return Mesh(devices[: n_z * n_y].reshape(n_z, n_y), ("z", "y"))


def grid_sharding(mesh: Mesh, ndim: int, shape=None) -> NamedSharding:
    """Sharding for an array whose trailing 3 dims are (z, y, x).  When the
    shape is given, axes whose extent the mesh does not divide evenly fall
    back to replication (device_put requires even splits; the solver-side
    padded arrays inside the shard_map tier are always evenly divisible)."""
    spec = [None] * (ndim - 3) + ["z", "y", None]
    if shape is not None:
        for off, axis in ((-3, "z"), (-2, "y")):
            n_ax = mesh.shape.get(axis, 1)
            if n_ax > 1 and shape[off] % n_ax:
                spec[off] = None
                key = (axis, n_ax, shape[off])
                if key not in _warned_replicated:  # once per (axis, extent)
                    _warned_replicated.add(key)
                    warnings.warn(
                        f"grid axis {axis} (extent {shape[off]}) is not "
                        f"divisible by the mesh's {n_ax} {axis}-devices; the "
                        f"array is replicated along {axis} and that mesh "
                        f"dimension contributes no parallelism", stacklevel=3)
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _put_grid(x, mesh):
    if hasattr(x, "ndim") and x.ndim >= 3:
        return jax.device_put(x, grid_sharding(mesh, x.ndim, x.shape))
    return jax.device_put(x, replicated(mesh))


def shard_system(system, mesh: Mesh, include_op: bool = True):
    """Place an AssembledSystem's device arrays on the mesh.

    ``include_op=False`` drops the operator's coefficient streams instead
    of placing them: the explicit shard_map tier (parallel/shard_op.py)
    owns its own padded per-device copies and never reads ``system.op``
    after construction, so placing both would hold ~2x the coefficient HBM
    per device for the run's lifetime.  Host ``np_*`` copies and the box
    metadata stay available either way."""
    from ..assembly.assemble import AssembledSystem
    from ..assembly.stencil import StencilOperator
    import jax.numpy as jnp

    if include_op:
        op = StencilOperator(
            ka=_put_grid(system.op.ka, mesh),
            # the box-restricted U-coupling streams are small; replicate them
            gu=jax.device_put(system.op.gu, replicated(mesh)),
            ku=jax.device_put(system.op.ku, replicated(mesh)),
            da=jax.device_put(system.op.da, replicated(mesh)),
            box=system.op.box,
        )
    else:
        empty = lambda a: jnp.zeros((0,) * a.ndim, a.dtype)
        op = StencilOperator(
            ka=empty(system.op.ka), gu=empty(system.op.gu),
            ku=empty(system.op.ku), da=empty(system.op.da),
            box=system.op.box,
        )
    return AssembledSystem(
        op=op,
        cond_mask=_put_grid(system.cond_mask, mesh),
        inert=_put_grid(system.inert, mesh),
        bnd_a=_put_grid(system.bnd_a, mesh),
        bnd_u=_put_grid(system.bnd_u, mesh),
        np_ka=system.np_ka, np_gu=system.np_gu,
        np_ku=system.np_ku, np_da=system.np_da,
        gershgorin=system.gershgorin,
    )


def shard_state(state, mesh: Mesh):
    from ..sim.simulate import SimState
    from ..sim.motion import MotionState

    from ..assembly.stencil import State

    return SimState(
        A=_put_grid(state.A, mesh),
        U=_put_grid(state.U, mesh),
        carry=_put_grid(state.carry, mesh),
        motion=MotionState(
            distance=jax.device_put(state.motion.distance, replicated(mesh)),
            movestop=jax.device_put(state.motion.movestop, replicated(mesh)),
            comp=jax.device_put(state.motion.comp, replicated(mesh)),
        ),
        prev=(State(_put_grid(state.prev.A, mesh), _put_grid(state.prev.U, mesh))
              if state.prev is not None else None),
    )
