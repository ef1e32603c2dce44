"""General sparse tier (ops/sparse.py) vs scipy."""

import numpy as np
import jax
import jax.numpy as jnp
from scipy import sparse

from eddy_currents_3d_tpu.ops.sparse import from_scipy


def _rand_csr(rng, n=60, density=0.08):
    m = sparse.random(n, n, density=density, random_state=np.random.RandomState(3))
    m = m.tocsr()
    m.setdiag(1.0)
    return m


def test_csr_matvec(rng):
    m = _rand_csr(rng)
    x = rng.standard_normal(m.shape[1])
    ours = from_scipy(m, jnp.float64)
    np.testing.assert_allclose(np.asarray(ours.matvec(jnp.asarray(x))), m @ x, rtol=1e-12)


def test_coo_and_dense(rng):
    m = _rand_csr(rng, n=30)
    ours = from_scipy(m, jnp.float64)
    coo = ours.to_coo()
    x = rng.standard_normal(30)
    np.testing.assert_allclose(np.asarray(coo.matvec(jnp.asarray(x))), m @ x, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(coo.todense()), m.toarray(), rtol=1e-12)


def test_ell_matvec(rng):
    m = _rand_csr(rng, n=50)
    ours = from_scipy(m, jnp.float64)
    ell = ours.to_ell()
    x = rng.standard_normal(50)
    np.testing.assert_allclose(np.asarray(ell.matvec(jnp.asarray(x))), m @ x, rtol=1e-12)
    assert ell.vals.shape[1] == int(np.diff(m.indptr).max())


def test_jit_and_tree_flatten(rng):
    import jax
    m = _rand_csr(rng, n=40)
    ours = from_scipy(m, jnp.float64)
    x = rng.standard_normal(40)
    f = jax.jit(lambda mat, v: mat.matvec(v))
    np.testing.assert_allclose(np.asarray(f(ours, jnp.asarray(x))), m @ x, rtol=1e-12)


# ---------------------------------------------------------------------------
# SpMM / BSR / SpGEMM (new general-sparse tier)
# ---------------------------------------------------------------------------

def test_spmm_all_formats(rng):
    m = _rand_csr(rng, n=48)
    x = rng.standard_normal((48, 7))
    want = m @ x
    ours = from_scipy(m, jnp.float64)
    np.testing.assert_allclose(np.asarray(ours.matmat(jnp.asarray(x))), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ours.to_coo().matmat(jnp.asarray(x))), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ours.to_ell().matmat(jnp.asarray(x))), want, rtol=1e-12)


def test_csr_diagonal(rng):
    m = _rand_csr(rng, n=37)
    ours = from_scipy(m, jnp.float64)
    np.testing.assert_allclose(np.asarray(ours.diagonal()), m.diagonal(), rtol=1e-12)


def test_bsr_matvec_matmat_dense(rng):
    from eddy_currents_3d_tpu.ops.sparse import bsr_from_scipy

    m = _rand_csr(rng, n=50)  # not a multiple of the block size -> padding
    b = bsr_from_scipy(m, block_shape=(4, 8), dtype=jnp.float64)
    assert b.shape == (52, 56)
    dense = np.zeros(b.shape)
    dense[:50, :50] = m.toarray()
    np.testing.assert_allclose(np.asarray(b.todense()), dense, rtol=1e-12)
    x = rng.standard_normal(56)
    np.testing.assert_allclose(np.asarray(b.matvec(jnp.asarray(x))), dense @ x, rtol=1e-12)
    X = rng.standard_normal((56, 5))
    np.testing.assert_allclose(np.asarray(b.matmat(jnp.asarray(X))), dense @ X, rtol=1e-12)


def test_spgemm_vs_scipy(rng):
    from eddy_currents_3d_tpu.ops.sparse import from_scipy as fs, spgemm

    a = sparse.random(40, 55, density=0.1, random_state=np.random.RandomState(7)).tocsr()
    b = sparse.random(55, 33, density=0.12, random_state=np.random.RandomState(8)).tocsr()
    c = spgemm(fs(a, jnp.float64), fs(b, jnp.float64))
    want = (a @ b).toarray()
    got = np.zeros(c.shape)
    indptr = np.asarray(c.indptr); cols = np.asarray(c.cols); vals = np.asarray(c.vals)
    for i in range(c.shape[0]):
        got[i, cols[indptr[i]:indptr[i + 1]]] = vals[indptr[i]:indptr[i + 1]]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_spgemm_plan_reuse(rng):
    """Numeric phase is jittable and reusable across value changes."""
    import jax
    from eddy_currents_3d_tpu.ops.sparse import from_scipy as fs, spgemm_plan

    a = sparse.random(30, 30, density=0.15, random_state=np.random.RandomState(9)).tocsr()
    b = a.T.tocsr()
    plan = spgemm_plan(fs(a, jnp.float64), fs(b, jnp.float64))
    numeric = jax.jit(plan.numeric)
    for scale in (1.0, 3.5):
        c = numeric(jnp.asarray(a.data * scale), jnp.asarray(b.data))
        want = ((a * scale) @ b).toarray()
        np.testing.assert_allclose(np.asarray(c.todense()), want, rtol=1e-12, atol=1e-13)


def test_bsr_spmm_float32_full_precision(rng):
    """The float32 block product is pinned to full float32 precision: a
    TF32 contraction (about three decimal digits) would miss this bound."""
    from eddy_currents_3d_tpu.ops.sparse import bsr_from_scipy

    m = _rand_csr(rng, n=64, density=0.1)
    b = bsr_from_scipy(m, block_shape=(8, 16), dtype=jnp.float32)
    x = rng.standard_normal((b.shape[1], 4)).astype(np.float32)
    hlo = jax.jit(b.matmat).lower(jnp.asarray(x)).as_text()
    assert "HIGHEST" in hlo
    y = b.matmat(jnp.asarray(x))
    want = np.asarray(b.todense(), np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(np.asarray(y, np.float64), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
