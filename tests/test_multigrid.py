"""Geometric multigrid: Galerkin coarsening vs explicit R A P, V-cycle
contraction on Poisson, and preconditioned-simulation field agreement."""

import numpy as np
import jax.numpy as jnp
from scipy import sparse

from eddy_currents_3d_tpu.solvers.multigrid import (
    build_mg, galerkin_coarsen, stencil7_apply, _restrict, _prolong,
)


def _stencil_to_matrix(ka):
    """Dense matrix of the flat-roll stencil apply (wrap entries included —
    they carry zero coefficients in valid fields)."""
    _, nz, ny, nx = ka.shape
    N = nz * ny * nx
    k2 = np.asarray(ka).reshape(7, N)
    strides = (1, nx, nx * ny)
    A = np.zeros((N, N))
    idx = np.arange(N)
    A[idx, idx] += k2[0]
    for o, (ax, d) in ((1, (0, -1)), (2, (0, +1)), (3, (1, -1)),
                       (4, (1, +1)), (5, (2, -1)), (6, (2, +1))):
        cols = (idx + d * strides[ax]) % N
        A[idx, cols] += k2[o]
    return A


def _poisson_ka(nz, ny, nx, rng=None):
    """7-point Laplacian coefficients with boundary rows dropping the
    outward neighbor (the flat-roll invariant), optional random jitter."""
    ka = np.zeros((7, nz, ny, nx))
    ka[0] = 6.0
    ka[1:] = -1.0
    ka[1, :, :, 0] = 0.0; ka[2, :, :, -1] = 0.0
    ka[3, :, 0, :] = 0.0; ka[4, :, -1, :] = 0.0
    ka[5, 0, :, :] = 0.0; ka[6, -1, :, :] = 0.0
    if rng is not None:
        ka[0] += rng.uniform(0, 0.5, ka[0].shape)   # keep diagonally dominant
    return ka


def _prolong_matrix(shape_c, shape_f):
    """Explicit P: coarse -> 2x2x2 children (fine grid = 2x coarse)."""
    Zc, Yc, Xc = shape_c
    nz, ny, nx = shape_f
    P = np.zeros((nz * ny * nx, Zc * Yc * Xc))
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                fi = (z * ny + y) * nx + x
                ci = ((z // 2) * Yc + y // 2) * Xc + x // 2
                P[fi, ci] = 1.0
    return P


def test_galerkin_equals_explicit_rap(rng):
    ka = _poisson_ka(4, 6, 8, rng)
    A = _stencil_to_matrix(ka)
    P = _prolong_matrix((2, 3, 4), (4, 6, 8))
    want = P.T @ A @ P
    kc = galerkin_coarsen(ka)
    got = _stencil_to_matrix(kc)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_restrict_prolong_adjoint(rng):
    r = rng.standard_normal((4, 6, 8))
    e = rng.standard_normal((2, 3, 4))
    # <R r, e> == <r, P e>
    lhs = float(np.sum(np.asarray(_restrict(jnp.asarray(r))) * e))
    rhs = float(np.sum(r * np.asarray(_prolong(jnp.asarray(e)))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_vcycle_contracts_poisson(rng):
    ka = _poisson_ka(8, 8, 8)
    mg = build_mg(ka, dtype=jnp.float64)
    assert len(mg.levels) >= 2
    b = jnp.asarray(rng.standard_normal((8, 8, 8)))
    x = mg.apply_scalar(b)
    r1 = np.linalg.norm(np.asarray(b - stencil7_apply(mg.levels[0].ka, x)))
    r0 = np.linalg.norm(np.asarray(b))
    assert r1 < 0.3 * r0, f"V-cycle contraction only {r1 / r0:.3f}"
    # iterated cycles keep contracting (piecewise-constant transfer has an
    # asymptotic rate ~0.5 — adequate for a Krylov preconditioner)
    x = x + mg.apply_scalar(b - stencil7_apply(mg.levels[0].ka, x))
    r2 = np.linalg.norm(np.asarray(b - stencil7_apply(mg.levels[0].ka, x)))
    assert r2 < 0.6 * r1


def test_mg_preconditioned_simulation_matches_plain():
    from eddy_currents_3d_tpu.sim.simulate import Simulation
    from eddy_currents_3d_tpu.testing.cases import case_static, load_case

    model = load_case(case_static(shape_xyz=(20, 20, 12), steps=3))
    plain = Simulation(model, dtype=jnp.float64, dot_dtype=jnp.float64)
    st_p, d_p = plain.run_scan()
    mg = Simulation(model, dtype=jnp.float64, dot_dtype=jnp.float64,
                    precond="mg")
    st_m, d_m = mg.run_scan()
    assert bool(np.all(np.asarray(d_m["converged"])))
    # fewer iterations than unpreconditioned
    assert int(np.sum(d_m["iterations"])) < int(np.sum(d_p["iterations"]))
    scale = float(np.abs(np.asarray(st_p.A)).max())
    assert float(np.abs(np.asarray(st_m.A) - np.asarray(st_p.A)).max()) < 2e-2 * scale
