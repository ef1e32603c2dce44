"""Golden regression on the reference's headline TEAM7-modified case.

PROVENANCE: tests/goldens/team7_10step.npz is this framework's *own* f64
output (committed with the first stencil operator) — a fast regression pin
against unintended change, NOT an independent check.  The independent
production-scale anchor is tests/goldens/team7_oracle.npz (generated by
the per-cell Fortran-style transcription, see test_oracle_golden.py),
which a bug shared by the framework step and this golden cannot fool.

The golden holds the state after 10 implicit steps of
``compare_to_Elmer.vxc`` computed in float64 — the same discretization the
reference Fortran solves.  Requires the read-only reference mount for the
input file."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from eddy_currents_3d_tpu.models.vxc import read_vxc
from eddy_currents_3d_tpu.sim.simulate import Simulation

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "team7_10step.npz")


@pytest.fixture(scope="module")
def team7(ref_path):
    return read_vxc(os.path.join(ref_path, "compare_to_Elmer.vxc"))


def _run(model, dtype, dot_dtype=None, steps=10):
    # warm_start="previous": the goldens pin the reference's exact iterate
    # path (EC3D.f90:408 warm start); the extrapolated production default
    # is tolerance-equivalent but not trajectory-identical
    sim = Simulation(model, dtype=dtype, dot_dtype=dot_dtype,
                     warm_start="previous")
    state = sim.init_state()
    iters = []
    for t, _ in sim.steps[:steps]:
        state, info = sim._step_jit(state, t)
        iters.append(int(info.iterations))
        assert bool(info.converged)
    return state, iters


def test_team7_f64_matches_golden(team7):
    g = np.load(GOLDEN)
    state, iters = _run(team7, jnp.float64, jnp.float64)
    # BiCGSTAB trajectories are stable only to ~solver tol against floating
    # point reassociation (any change of summation order perturbs iterates),
    # so the bound is a fraction of the 5e-3 solve tolerance, not eps.
    for name, got in (("A", state.A), ("carry", state.carry), ("U", state.U)):
        ref = g[name].astype(np.float64)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3 * scale,
                                   err_msg=name)


@pytest.mark.slow
def test_team7_f32_drift_100_steps(team7):
    """Full-transient mixed-precision drift bound: 100 steps of the real
    TEAM7 case in f32 vs f64 (promotes the observed ~2e-3 hardware figure
    to an asserted bound; run with `pytest -m slow`)."""
    s64, _ = _run(team7, jnp.float64, jnp.float64, steps=100)
    s32, _ = _run(team7, jnp.float32, steps=100)
    for name in ("A", "carry"):
        ref = np.asarray(getattr(s64, name), np.float64)
        got = np.asarray(getattr(s32, name), np.float64)
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max() / scale
        assert err < 5e-3, f"{name}: 100-step f32 drift {err:.2e}"


def test_team7_f32_within_solver_tolerance(team7):
    g = np.load(GOLDEN)
    state, iters = _run(team7, jnp.float32)
    # production dtype vs float64. A is the solution (bounded by the solve
    # tolerance); carry is a *difference* of comparable terms
    # ((2C/dt)A - rhs, EC3D.f90:420-422), so its pointwise error amplifies
    # to a few x tol early in the transient (observed ~1e-2 at step 10,
    # ~2e-3 at step 100 on hardware).
    bound = {"A": 5e-3, "carry": 3e-2}
    for name, got in (("A", state.A), ("carry", state.carry)):
        ref = g[name].astype(np.float64)
        scale = np.abs(ref).max()
        err = np.abs(np.asarray(got, np.float64) - ref).max()
        assert err < bound[name] * scale, f"{name}: rel err {err/scale:.2e}"
