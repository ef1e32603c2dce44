"""Stencil-form ILU(0) (solvers/ilu0.py ilu0_stencil_factorize): the
factors extracted into coefficient fields must define exactly the same
linear maps as the CSR/ELL factorization they came from — including the
shared-A-block invariant and the entrywise ku lower/upper split under the
reference's non-monotone conducting numbering."""

import numpy as np
import jax.numpy as jnp

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator, to_csr
from eddy_currents_3d_tpu.assembly.stencil import State
from eddy_currents_3d_tpu.ops.sparse import CSRMatrix
from eddy_currents_3d_tpu.solvers.ilu0 import (
    ilu0_factorize, ilu0_stencil_factorize,
)
from eddy_currents_3d_tpu.testing.cases import case_static, load_case


def _setup(shape=(14, 12, 10)):
    model = load_case(case_static(shape_xyz=shape, steps=2))
    sysm = assemble_operator(model, jnp.float64)
    csr = to_csr(sysm, model)
    csr.sort_indices()
    ell = ilu0_factorize(
        CSRMatrix(indptr=jnp.asarray(csr.indptr), cols=jnp.asarray(csr.indices),
                  vals=jnp.asarray(csr.data), shape=csr.shape),
        dtype=jnp.float64)
    st = ilu0_stencil_factorize(sysm, model, dtype=jnp.float64)
    return model, sysm, ell, st


def _flatten(model, v: State) -> np.ndarray:
    """State -> the reference's global [Ax|Ay|Az|U] vector."""
    N = v.A[0].size
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    u_cells = order[np.argsort(condno[order])]
    return np.concatenate([np.asarray(v.A).reshape(3 * N),
                           np.asarray(v.U).ravel()[u_cells]])


def _unflatten(model, shape_zyx, z: np.ndarray) -> State:
    N = int(np.prod(shape_zyx))
    condno = model.cond_number.ravel()
    order = np.nonzero(condno)[0]
    u_cells = order[np.argsort(condno[order])]
    U = np.zeros(N)
    U[u_cells] = z[3 * N:]
    return State(jnp.asarray(z[:3 * N].reshape((3,) + shape_zyx)),
                 jnp.asarray(U.reshape(shape_zyx)))


def _rand_state(model, shape_zyx, rng) -> State:
    A = rng.standard_normal((3,) + shape_zyx)
    U = rng.standard_normal(shape_zyx) * np.asarray(model.cond_mask)
    return State(jnp.asarray(A), jnp.asarray(U))


def test_stencil_apply_matches_ell(rng):
    """Same sweeps, same factors => bitwise-same preconditioner map (up to
    fp reassociation) as the flat ELL application."""
    model, sysm, ell, st = _setup()
    shape_zyx = sysm.shape_zyx
    v = _rand_state(model, shape_zyx, rng)
    for sweeps in (1, 2, 4):
        zs = st.apply(v, sweeps=sweeps)
        zf = np.asarray(ell.apply(jnp.asarray(_flatten(model, v)),
                                  sweeps=sweeps))
        want = _unflatten(model, shape_zyx, zf)
        np.testing.assert_allclose(np.asarray(zs.A), np.asarray(want.A),
                                   rtol=1e-11, atol=1e-13)
        np.testing.assert_allclose(np.asarray(zs.U), np.asarray(want.U),
                                   rtol=1e-11, atol=1e-13)


def test_stencil_matvec_matches_ell(rng):
    """M x = L(U x) agreement (the warm-start map)."""
    model, sysm, ell, st = _setup()
    v = _rand_state(model, sysm.shape_zyx, rng)
    ms = st.matvec(v)
    mf = np.asarray(ell.matvec(jnp.asarray(_flatten(model, v))))
    want = _unflatten(model, sysm.shape_zyx, mf)
    np.testing.assert_allclose(np.asarray(ms.A), np.asarray(want.A),
                               rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ms.U), np.asarray(want.U),
                               rtol=1e-11, atol=1e-13)


def test_shared_block_invariant():
    """The three A components factor to identical block coefficients (the
    within-block elimination never reads a component-specific value), so
    extracting from block 0 is lossless: check blocks 1 and 2 of the
    factored CSR against the extracted fields."""
    model, sysm, ell, st = _setup(shape=(12, 10, 9))
    csr = to_csr(sysm, model)
    csr.sort_indices()
    from eddy_currents_3d_tpu.ops.native import ilu0_native
    from eddy_currents_3d_tpu.solvers.ilu0 import _ilu0_numpy
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int32)
    fv = ilu0_native(indptr, cols, np.asarray(csr.data, np.float64))
    if fv is None:
        fv = _ilu0_numpy(indptr, cols, np.asarray(csr.data, np.float64))
    fcsr = csr.copy()
    fcsr.data = fv
    nz, ny, nx = sysm.shape_zyx
    N = nx * ny * nz
    kaL = np.asarray(st.L_op.ka).reshape(7, N)
    kaU = np.asarray(st.U_op.ka).reshape(7, N)
    dA = np.asarray(st.d_A).ravel()
    from eddy_currents_3d_tpu.assembly.stencil import OFFSETS7
    stride = {0: 1, 1: nx, 2: nx * ny}
    flat = np.arange(N)
    for comp in (1, 2):
        for o, (axis, d) in enumerate(OFFSETS7):
            keep = sysm.np_ka[o].ravel() != 0.0
            tgt = flat if d == 0 else flat + d * stride[axis]
            got = np.asarray(
                fcsr[comp * N + flat[keep], comp * N + tgt[keep]]).ravel()
            want = (dA if o == 0 else (kaL[o] + kaU[o]))[keep]
            np.testing.assert_allclose(got, want, rtol=1e-12)


def test_simulation_stencil_ilu0_converges():
    """Simulation(precond='ilu0') runs the stencil form and matches the
    unpreconditioned fields within the solve tolerance."""
    from eddy_currents_3d_tpu.sim.simulate import Simulation

    model = load_case(case_static(shape_xyz=(12, 12, 10), steps=3))
    # "previous" on both sides: comparing two tolerance-converged solves
    # needs a common iterate path for a tight bound
    ref, _ = Simulation(model, dtype=jnp.float64,
                        warm_start="previous").run()
    sim = Simulation(model, dtype=jnp.float64, precond="ilu0",
                     warm_start="previous")
    from eddy_currents_3d_tpu.solvers.ilu0 import StencilILU0
    assert isinstance(sim._ilu, StencilILU0)
    ilu, idiag = sim.run()
    assert not idiag["unconverged_steps"]
    scale = np.abs(np.asarray(ref.A)).max()
    np.testing.assert_allclose(np.asarray(ilu.A), np.asarray(ref.A),
                               atol=6e-3 * scale)
