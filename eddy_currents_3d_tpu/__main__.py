"""Command-line driver: ``python -m eddy_currents_3d_tpu [in.vxc]``.

The reference is a single executable run with ``in.vxc`` in the working
directory (EC3D.f90:5, 86-89); this CLI reproduces that workflow — default
input ``in.vxc``, output directory from the case's ``SOLVER DIR`` line
(``vxc2data.f90:74`` default ``out``), parsed-parameter and matrix-stats
prints, the 1% ``>`` progress ticker, and the final ``Tcalc`` wall-time
print — plus the accelerator extras (dtype, device mesh, preconditioning,
checkpoint/resume) behind flags.
"""

from __future__ import annotations

import argparse
import os
import sys


def _dtype(name: str):
    import jax.numpy as jnp

    return {
        "f32": jnp.float32, "float32": jnp.float32,
        "bf16": jnp.bfloat16, "bfloat16": jnp.bfloat16,
        "f64": jnp.float64, "float64": jnp.float64,
    }[name]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m eddy_currents_3d_tpu",
        description="3D time-domain eddy-current simulation on JAX "
        "(VoxCad .vxc input, legacy-VTK output).",
    )
    p.add_argument("vxc", nargs="?", default="in.vxc",
                   help="input .vxc case (default: in.vxc in the cwd, like "
                   "the reference executable)")
    p.add_argument("-o", "--out", default=None,
                   help="output directory (default: the case's SOLVER DIR, "
                   "usually 'out'); pass '-' to skip VTK output")
    p.add_argument("--dtype", default="f32",
                   choices=["f32", "float32", "bf16", "bfloat16", "f64", "float64"],
                   help="field dtype (default f32; f64 needs JAX_ENABLE_X64)")
    p.add_argument("--dot-dtype", default=None,
                   choices=[None, "f32", "f64"],
                   help="accumulate solver dot products in this dtype")
    p.add_argument("--coeff-dtype", default=None,
                   choices=[None, "bf16", "f32"],
                   help="store the operator coefficient streams in this "
                   "dtype (bf16 halves matvec HBM traffic; state and "
                   "accumulation stay in --dtype)")
    p.add_argument("--steps", type=int, default=None,
                   help="run only the first N timesteps")
    p.add_argument("--precond", default=None,
                   choices=["cheb", "jacobi", "cheb_jacobi", "mg", "ilu0"],
                   help="right preconditioning: Chebyshev polynomial, "
                   "Jacobi, Chebyshev-on-Jacobi-scaled, or geometric "
                   "multigrid V-cycle")
    p.add_argument("--mesh", default=None, metavar="Z[,Y]",
                   help="shard over a ZxY device mesh (e.g. --mesh 4 or "
                   "--mesh 4,2) through the explicit shard_map+halo tier "
                   "(2-D decompositions included)")
    p.add_argument("--warm-start", default="extrapolate",
                   choices=["extrapolate", "previous"],
                   help="per-step solver warm start: linear extrapolation "
                   "of the last two solutions (default; ~1.4x fewer "
                   "iterations at the same residual tolerance) or the "
                   "reference's previous-solution start (EC3D.f90:408)")
    p.add_argument("--scan", action="store_true",
                   help="run the transient as one on-device lax.scan "
                   "dispatch (max throughput; VTK output streams via "
                   "io_callback; with --checkpoint-dir the run segments "
                   "at checkpoint boundaries)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write ckpt_<step>.npz files here")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="checkpoint every N steps (requires --checkpoint-dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --checkpoint-dir")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the parameter/progress prints")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if not os.path.exists(args.vxc):
        print(f"error: input file {args.vxc!r} not found "
              "(the reference reads in.vxc from the working directory)",
              file=sys.stderr)
        return 2
    if args.resume and not args.checkpoint_dir:
        print("error: --resume requires --checkpoint-dir", file=sys.stderr)
        return 2
    if args.checkpoint_dir and not args.checkpoint_every and not args.resume:
        print("error: --checkpoint-dir without --checkpoint-every writes no "
              "checkpoints; pass --checkpoint-every N (or --resume to "
              "continue from an existing run)", file=sys.stderr)
        return 2

    if args.dtype in ("f64", "float64"):
        import jax

        jax.config.update("jax_enable_x64", True)
    import jax
    import jax.numpy as jnp

    from .models.vxc import read_vxc
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from .sim.simulate import Simulation

    model = read_vxc(args.vxc)
    outdir = args.out if args.out is not None else model.solver.files
    output_dir = None if outdir == "-" else outdir

    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        dims = [int(x) for x in args.mesh.split(",")]
        mesh = make_mesh(dims[0], dims[1] if len(dims) > 1 else 1)

    sim = Simulation(
        model,
        dtype=_dtype(args.dtype),
        dot_dtype=_dtype(args.dot_dtype) if args.dot_dtype else None,
        coeff_dtype=_dtype(args.coeff_dtype) if args.coeff_dtype else None,
        mesh=mesh,
        precond=args.precond,
        warm_start=args.warm_start,
    )

    info = not args.quiet
    if info:
        sdx, sdy, sdz = model.shape_xyz
        # the reference prints grid/domain/solver parameters during parsing
        # (vxc2data.f90:99-248) and matrix stats after assembly
        # (EC3D.f90:965-971, 1046-1047)
        st = sim.system.matrix_stats()   # exact counts of the assembled coeffs
        print(f"case      : {args.vxc}")
        print(f"grid      : {sdx} x {sdy} x {sdz} = {model.n_cells} cells "
              f"({model.n_cond} conducting)")
        print(f"unknowns  : {3 * model.n_cells + model.n_cond} "
              f"(3N A-rows + {model.n_cond} U-rows)")
        print(f"matrix    : num_nzX= {st['nnz_x']} num_nzY= {st['nnz_y']} "
              f"num_nzZ= {st['nnz_z']} num_nzU= {st['nnz_u']}")
        print(f"            num_bndX= {st['bnd_x']} num_bndY= {st['bnd_y']} "
              f"num_bndZ= {st['bnd_z']}")
        print(f"            Non zero elem= {st['nnz']} "
              f"Density of matrix: {st['density_pct']:.5g}%")
        print(f"domains   : {model.nsub} material + {model.nsub_air} air, "
              f"{len(model.functions)} source fn, {len(model.vmech)} motion fn")
        print(f"transient : stop={model.tran.stop} step={model.tran.step} "
              f"jump={model.tran.jump} -> {sim.n_steps} steps")
        print(f"solver    : {model.solver.solv} tol={model.solver.tolerance} "
              f"itmax={model.solver.itmax} bound={model.solver.bound}")
        dev = jax.devices()[0]
        ndev = mesh.devices.size if mesh is not None else 1
        print(f"backend   : {dev.platform} x{ndev}, dtype={args.dtype}, "
              f"operator={sim.operator_name}"
              f"{', precond=' + args.precond if args.precond else ''}")
        if output_dir:
            print(f"output    : {output_dir}/field_N.vtk, src_N.vtk")

    if args.scan:
        import time as _time

        t0 = _time.perf_counter()
        state, sdiag = sim.run_scan(num_steps=args.steps,
                                    output_dir=output_dir,
                                    checkpoint_dir=args.checkpoint_dir,
                                    checkpoint_every=args.checkpoint_every,
                                    resume=args.resume)
        jax.block_until_ready(state)
        wall = _time.perf_counter() - t0
        import numpy as np

        start = int(sdiag.get("start_step", 0))
        it = np.asarray(sdiag["iterations"]).tolist()
        diag = {
            # chunked scan paths report their measured host-io time; the
            # pure io_callback path streams writes off the host loop and
            # reports 0.0
            "wall_s": wall, "io_s": float(sdiag.get("io_s", 0.0)),
            "steps": len(it),
            "iterations": it, "total_iterations": int(sum(it)),
            "unconverged_steps":
                [start + i
                 for i, c in enumerate(np.asarray(sdiag["converged"]))
                 if not c],
        }
    else:
        state, diag = sim.run(
            num_steps=args.steps,
            output_dir=output_dir,
            progress=info,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )

    if info:
        print()
        it = diag["iterations"]
        med = sorted(it)[len(it) // 2] if it else 0
        # "Tcalc" is the reference's end-of-run wall-time print (EC3D.f90:461)
        print(f"Tcalc = {diag['wall_s']:.2f} s "
              f"({diag['wall_s'] / max(diag['steps'], 1):.4f} s/step, "
              f"io {diag['io_s']:.2f} s)")
        print(f"solver    : {diag['total_iterations']} iterations total, "
              f"median {med}/step, "
              f"{len(diag['unconverged_steps'])} unconverged step(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
