#!/usr/bin/env python
"""Smoke test of the solver on the GPU, through the package's entry points.

Usage::

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the z-slab mesh phase only

One card runs, in one process:

1. device: JAX's devices and the card's name and power limit;
2. the CLI (``python -m eddy_currents_3d_tpu --scan``) on the TEAM7-size
   static stand-in, 102x102x24 for 100 steps, with its VTK output;
3. ``Simulation.run_scan`` with output on the moving-coil and LIM cases;
4. the 256x256x64 scale class: set-up (compile) time, time per step,
   iterations and peak device memory;
5. the float32 operator(s) against the float64 field operator;
6. a 10-step float32 transient against float64 (solver tolerance 5e-4,
   so that the difference is the arithmetic's and not the stopping
   point's; the difference at the case's 5e-3 is printed beside it).

Every phase raises on failure.  The script prints one line per phase, the
card's name and power limit, and last one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.  It exits non-zero
without that line when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(ROOT, ".chip_smoke")     # ignored by git

TEAM7 = (102, 102, 24)
SCALE = (256, 256, 64)
LIM = (176, 32, 22)
OP_TOL = 3e-6                        # per block, of max|y| (test_coded.py)
DRIFT_TOL = {"A": 5e-3, "carry": 3e-2}   # f32 vs f64 (test_golden_team7.py)
MESH_TOL = 1e-4                      # sharded vs one device (__graft_entry__)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them, read by a
    child process that does not import JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _say(phase: str, card: str, text: str) -> None:
    print(f"[{phase}] {text} | {card}", flush=True)


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def _require(cond, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def _converged(diag) -> bool:
    return bool(np.asarray(diag["converged"]).all())


def _timed_scan(sim, **kw):
    """(state, diag, seconds) of one run_scan, ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    state, diag = sim.run_scan(**kw)
    jax.block_until_ready(state)
    return state, diag, time.perf_counter() - t0


def phase_device(card: str) -> None:
    import jax

    dev = jax.devices()[0]
    _say("device", card, f"jax.devices()={jax.devices()} "
         f"device_kind={dev.device_kind!r}")


def phase_cli(card, workdir, platform="gpu", shape=TEAM7, steps=100,
              jump_steps=10) -> None:
    """The CLI on the static stand-in, --scan with VTK output."""
    from eddy_currents_3d_tpu.__main__ import main as cli
    from eddy_currents_3d_tpu.io.vtk import read_vtk_vectors
    from eddy_currents_3d_tpu.models.vxc import read_vxc
    from eddy_currents_3d_tpu.sim.simulate import _schedule
    from eddy_currents_3d_tpu.testing.cases import case_static

    os.makedirs(workdir, exist_ok=True)
    vxc = os.path.join(workdir, "static.vxc")
    dt = 1e-3
    with open(vxc, "w") as f:
        f.write(case_static(shape_xyz=shape, steps=steps, dt=dt,
                            jump=jump_steps * dt))
    out = os.path.join(workdir, "cli_out")
    shutil.rmtree(out, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([vxc, "--scan", "--dtype", "f32", "-o", out])
    log = buf.getvalue().splitlines()
    _require(rc == 0, f"CLI exit code {rc}")
    backend = next(l for l in log if l.startswith("backend"))
    _require(f": {platform} " in backend and "operator=" in backend,
             f"backend line: {backend!r}")
    solver = [l for l in log if l.startswith("solver    :")][-1]
    _require(" 0 unconverged step(s)" in solver, solver)
    points = [o for _, o in _schedule(read_vxc(vxc).tran) if o is not None]
    _require(points, "the schedule names no output")
    for n in points:
        for name in (f"field_{n}.vtk", f"src_{n}.vtk"):
            _require(os.path.exists(os.path.join(out, name)), f"no {name}")
        eddy = read_vtk_vectors(os.path.join(out, f"field_{n}.vtk"))[
            "Vector_field_eddy"]
        _require(np.isfinite(eddy).all() and np.abs(eddy).max() > 0,
                 f"field_{n}.vtk: eddy field not finite and nonzero")
    tcalc = next(l for l in log if l.startswith("Tcalc"))
    _say("cli", card, f"{shape} {steps} steps: {backend.strip()}; {tcalc}; "
         f"{solver.split(':', 1)[1].strip()}; {len(points)} field/src pairs")


def phase_mechanisms(card, workdir, moving_shape=TEAM7, lim_shape=LIM,
                     steps=20, jump_steps=5) -> None:
    """run_scan with output on the moving-coil and LIM cases.  Each runs
    the first half of a transient twice as long: the LIM coil reciprocates
    once over the whole transient and is back where it started at its end,
    and at the half it is at its far end."""
    import jax.numpy as jnp
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_lim, case_moving, load_case

    for name, text in (
            ("moving", case_moving(shape_xyz=moving_shape, steps=2 * steps,
                                   jump=jump_steps * 4e-4)),
            ("lim", case_lim(shape_xyz=lim_shape, steps=2 * steps,
                             jump=jump_steps * 1e-3))):
        sim = Simulation(load_case(text), dtype=jnp.float32)
        out = os.path.join(workdir, f"{name}_out")
        shutil.rmtree(out, ignore_errors=True)
        state, diag, wall = _timed_scan(sim, num_steps=steps, output_dir=out)
        _require(_converged(diag), f"{name}: unconverged step")
        dist = float(np.abs(np.asarray(state.motion.distance)).max())
        _require(dist > 0, f"{name}: the coil did not move")
        _require(any(f.startswith("field_") for f in os.listdir(out)),
                 f"{name}: no output")
        it = np.asarray(diag["iterations"])
        _say("mechanisms", card,
             f"{name} {sim.model.shape_xyz} {steps} steps: "
             f"operator={sim.operator_name}, {wall:.3f} s with compile, "
             f"iterations/step {it.mean():.2f}, coil moved {dist:.4g} cells")


def phase_scale(card, shape=SCALE, steps=5) -> None:
    """The scale class: compile as set-up, then the timed steps."""
    import jax
    import jax.numpy as jnp
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_static, load_case

    sim = Simulation(load_case(case_static(shape_xyz=shape, steps=steps)),
                     dtype=jnp.float32)
    _, _, first = _timed_scan(sim)
    state, diag, wall = _timed_scan(sim)
    _require(_converged(diag), "scale: unconverged step")
    _require(bool(jnp.isfinite(state.A).all()), "scale: non-finite A")
    it = np.asarray(diag["iterations"])
    peak = _peak_bytes(jax.devices()[0])
    _say("scale", card,
         f"{shape} ({int(np.prod(shape))} cells) {steps} steps: "
         f"operator={sim.operator_name}, set-up {first - wall:.3f} s, "
         f"{wall / steps * 1e3:.4f} ms/step, iterations/step {it.mean():.2f}, "
         f"peak_bytes_in_use {peak if peak is not None else 'not measured'}")


def phase_operator(card, shapes=(TEAM7, SCALE), seed=0) -> None:
    """The float32 apply of the selected operator (and of the field
    operator beside it) against the float64 field operator."""
    import jax
    import jax.numpy as jnp
    from eddy_currents_3d_tpu.assembly.assemble import assemble_operator
    from eddy_currents_3d_tpu.assembly.stencil import State
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_static, load_case

    for shape in shapes:
        model = load_case(case_static(shape_xyz=shape, steps=2))
        s64 = assemble_operator(model, jnp.float64)
        sim = Simulation(model, dtype=jnp.float32)
        rng = np.random.default_rng(seed)
        nz, ny, nx = model.shape_zyx
        A = rng.standard_normal((3, nz, ny, nx))
        U = rng.standard_normal((nz, ny, nx)) * np.asarray(s64.cond_mask)
        y64 = jax.jit(s64.op.apply)(State(jnp.asarray(A), jnp.asarray(U)))
        x32 = State(jnp.asarray(A, jnp.float32), jnp.asarray(U, jnp.float32))
        ops = {sim.operator_name: sim.operator}
        ops.setdefault("field", sim.system.op)
        for name, op in ops.items():
            y = jax.jit(op.apply)(x32)
            eA, eU = _rel(y.A, y64.A), _rel(y.U, y64.U)
            _require(eA <= OP_TOL and eU <= OP_TOL,
                     f"{name} {shape}: A {eA:.3e}, U {eU:.3e} > {OP_TOL}")
            _say("operator", card, f"{name} f32 vs field f64 {shape}: "
                 f"max|err|/max|y| A {eA:.3e}, U {eU:.3e} (limit {OP_TOL})")


def phase_precision(card, shape=TEAM7, steps=10, tight_tol=5e-4) -> None:
    """A float32 transient against the same transient in float64.  At the
    case's own solver tolerance (5e-3) both runs stop anywhere inside it,
    on different iterate paths, so their difference is of the order of
    that tolerance whatever the precision; that difference is printed.
    The bounds are checked with the solver tolerance at ``tight_tol``,
    where the difference left is the float32 arithmetic's."""
    import jax.numpy as jnp
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_static, load_case

    def drift(**case_kw):
        model = load_case(case_static(shape_xyz=shape, steps=steps, **case_kw))
        s32, d32, _ = _timed_scan(Simulation(model, dtype=jnp.float32))
        s64, d64, _ = _timed_scan(Simulation(model, dtype=jnp.float64,
                                             dot_dtype=jnp.float64))
        _require(_converged(d32) and _converged(d64), "precision: unconverged")
        errs = {k: _rel(getattr(s32, k), getattr(s64, k)) for k in DRIFT_TOL}
        return errs, model.solver.tolerance

    shipped, tol0 = drift()
    errs, tol1 = drift(tol=tight_tol)
    for k, e in errs.items():
        _require(e <= DRIFT_TOL[k], f"precision: {k} {e:.3e} > {DRIFT_TOL[k]}")
    fmt = lambda d: ", ".join(f"{k} {e:.3e}" for k, e in d.items())
    _say("precision", card, f"{shape} {steps} steps f32 vs f64: solver tol "
         f"{tol1}: {fmt(errs)} (limits {fmt(DRIFT_TOL)}); at the case's tol "
         f"{tol0} (stopping-point spread, not checked): {fmt(shipped)}")


def phase_four(card, shape=SCALE, steps=5, n=4) -> None:
    """The explicit shard tier on an n-device z mesh against one device.
    The check runs in float64, where both sides apply the same field
    operator and differ only in halo exchange and reduction order; in
    float32 the one-device run takes the coded operator and the two
    iterate paths stop at different points inside the solver tolerance.
    Float32 is timed, and checked for convergence and placement."""
    import jax
    import jax.numpy as jnp
    from eddy_currents_3d_tpu.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_static, load_case

    _require(len(jax.devices()) >= n, f"needs {n} devices")
    model = load_case(case_static(shape_xyz=shape, steps=steps))
    report = []
    for dtype in (jnp.float64, jnp.float32):
        one = Simulation(model, dtype=dtype)
        _timed_scan(one)
        ref, d1, t1 = _timed_scan(one)
        sim = Simulation(model, dtype=dtype, mesh=make_mesh(n, 1))
        _require(sim.shard_op is not None, "the shard tier did not engage")
        _timed_scan(sim)
        st, dn, tn = _timed_scan(sim)
        name = jnp.dtype(dtype).name
        _require(_converged(d1) and _converged(dn), f"four {name}: unconverged")
        _require(len(st.A.sharding.device_set) == n, "state not on the mesh")
        eA, eU = _rel(st.A, ref.A), _rel(st.U, ref.U)
        if dtype == jnp.float64:
            _require(eA < MESH_TOL and eU < MESH_TOL,
                     f"four: A {eA:.3e}, U {eU:.3e} >= {MESH_TOL}")
        report.append(
            f"{name}: 1 device {one.operator_name} {t1 / steps * 1e3:.4f} "
            f"ms/step, {n} devices {sim.operator_name} "
            f"{tn / steps * 1e3:.4f} ms/step, iterations/step "
            f"{np.asarray(d1['iterations']).mean():.2f} vs "
            f"{np.asarray(dn['iterations']).mean():.2f}, rel diff A {eA:.3e} "
            f"U {eU:.3e}" + (f" (limit {MESH_TOL})" if dtype == jnp.float64
                             else " (stopping-point spread, not checked)"))
        del one, sim, ref, st
    peaks = [_peak_bytes(d) for d in jax.devices()[:n]]
    if jax.devices()[0].platform != "cpu":     # the CPU reports no stats
        _require(all(p and p > 0 for p in peaks), f"peak bytes {peaks}")
    _say("four", card, f"{shape} {steps} steps: " + "; ".join(report)
         + f"; peak_bytes_in_use {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card z-slab mesh phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from eddy_currents_3d_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    phase_device(card)
    if args.four:
        phase_four(card)
    else:
        phase_cli(card, WORKDIR)
        phase_mechanisms(card, WORKDIR)
        phase_scale(card)
        phase_operator(card)
        phase_precision(card)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
