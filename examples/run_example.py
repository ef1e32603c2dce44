#!/usr/bin/env python
"""Run a .vxc case end-to-end and write VTK outputs.

Usage: python examples/run_example.py path/to/case.vxc [outdir]

Equivalent of running the reference EC3D executable with ``in.vxc`` in the
working directory — but on a GPU (or any JAX backend), with per-step solver
diagnostics printed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    path = sys.argv[1]

    import jax.numpy as jnp
    from eddy_currents_3d_tpu.models.vxc import read_vxc
    from eddy_currents_3d_tpu.sim.simulate import Simulation

    model = read_vxc(path)
    outdir = sys.argv[2] if len(sys.argv) > 2 else model.solver.files
    sdx, sdy, sdz = model.shape_xyz
    print(f"grid {sdx}x{sdy}x{sdz} = {model.n_cells} cells, "
          f"{model.n_cond} conducting, {len(model.functions)} source functions")
    sim = Simulation(model, dtype=jnp.float32)
    print(f"{sim.n_steps} steps, dt={model.tran.step}, tol={model.solver.tolerance}")
    state, diag = sim.run(output_dir=outdir, progress=True)
    print()
    it = diag["iterations"]
    print(f"done: wall {diag['wall_s']:.2f} s "
          f"({diag['wall_s']/diag['steps']:.4f} s/step), "
          f"solver iterations total {sum(it)} (median {sorted(it)[len(it)//2]})")
    print(f"outputs in {outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
