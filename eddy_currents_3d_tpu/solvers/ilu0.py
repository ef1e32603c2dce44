"""ILU(0) preconditioning — incomplete LU with zero fill on the CSR pattern.

The reference solver is unpreconditioned (solvers.f90:3-63); this is the
incomplete-factorization tier of this build (BASELINE "Jacobi/block-ILU0").

Split of the work between host and device:

* **Factorization** is inherently sequential row elimination, so it runs on
  host **once per assembly** — in the native C++ engine
  (native/ecsparse.cpp, ~100x the pure-numpy fallback) — never inside the
  timestep loop.
* **Application** ``z = U^-1 L^-1 v`` is what runs every Krylov iteration.
  Exact sequential triangular solves are the single worst pattern for a
  vector machine, so on device the triangular solves are applied as a
  *fixed number of Jacobi sweeps* (truncated Neumann series):

      L = I + Ls:        y_{k+1} = v - Ls y_k          (y_0 = v)
      U = D  + Us:       x_{k+1} = D^-1 (y - Us x_k)   (x_0 = D^-1 y)

  Each sweep is one ELL SpMV + axpy — dense streaming work.  With a fixed
  sweep count and fixed start the map v -> z is *linear and constant*, so it
  is a legitimate stationary preconditioner for BiCGSTAB (no flexible-Krylov
  machinery needed).  K sweeps reproduce the exact triangular solve whenever
  the factor's level-scheduling depth is <= K+1, and truncate it otherwise.

Right preconditioning keeps the residual history and convergence test those
of the original system: solve ``(A M^-1) y = b`` with ``x = M^-1 y`` and
warm start ``y_0 = M x_0 = L (U x_0)`` (both factors are retained for this).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sparse import CSRMatrix, ELLMatrix
from ..ops.native import ilu0_native, ilu0_solve_native
from .bicgstab import bicgstab_wr, SolveResult

__all__ = ["ilu0_factorize", "ILU0Preconditioner", "bicgstab_ilu0",
           "StencilILU0", "ilu0_stencil_factorize"]


def _ilu0_numpy(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Pure-numpy/python ILU(0) — fallback when the native engine is
    unavailable.  Same in-place algorithm as native/ecsparse.cpp."""
    n = indptr.shape[0] - 1
    vals = vals.astype(np.float64, copy=True)
    diag = np.full(n, -1, np.int64)
    pos = np.full(n, -1, np.int64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        rc = cols[lo:hi]
        if rc.size > 1 and np.any(np.diff(rc) <= 0):
            raise ValueError(f"ILU(0): unsorted columns in row {i}")
        pos[rc] = np.arange(lo, hi)
        for t in range(lo, hi):
            k = cols[t]
            if k >= i:
                break
            dk = diag[k]
            if dk < 0 or vals[dk] == 0.0:
                raise ZeroDivisionError(f"ILU(0): zero pivot in row {k}")
            lik = vals[t] / vals[dk]
            vals[t] = lik
            us = slice(dk + 1, indptr[k + 1])
            p = pos[cols[us]]
            hit = p >= 0
            vals[p[hit]] -= lik * vals[us][hit]
        d = np.nonzero(rc == i)[0]
        pos[rc] = -1
        if d.size == 0 or vals[lo + d[0]] == 0.0:
            raise ZeroDivisionError(f"ILU(0): zero or missing pivot in row {i}")
        diag[i] = lo + d[0]
    return vals


def _split_ell(indptr, cols, fvals, dtype):
    """Packed ILU(0) factors -> (strict-lower ELL, strict-upper ELL, diag)."""
    n = indptr.shape[0] - 1
    row = np.repeat(np.arange(n), np.diff(indptr))
    lower = cols < row
    upper = cols > row
    dmask = cols == row
    diag = np.zeros(n, np.float64)
    diag[row[dmask]] = fvals[dmask]

    def ell_of(mask):
        r, c, v = row[mask], cols[mask], fvals[mask]
        cnt = np.bincount(r, minlength=n)
        w = max(int(cnt.max()) if n else 0, 1)
        ec = np.zeros((n, w), np.int32)
        ev = np.zeros((n, w), np.float64)
        slot = np.arange(mask.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ec[r, slot] = c
        ev[r, slot] = v
        return ELLMatrix(cols=jnp.asarray(ec), vals=jnp.asarray(ev, dtype),
                         shape=(n, n))

    return ell_of(lower), ell_of(upper), jnp.asarray(diag, dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ILU0Preconditioner:
    """Device-resident ILU(0) factors with fixed-sweep application."""

    L: ELLMatrix            # strict lower of L (unit diagonal implied)
    U: ELLMatrix            # strict upper of U
    d: jax.Array            # diagonal of U
    inv_d: jax.Array

    def apply(self, v: jax.Array, sweeps: int = 4) -> jax.Array:
        """z ~= U^-1 L^-1 v via `sweeps` Jacobi sweeps per triangle."""
        y = v
        for _ in range(sweeps):
            y = v - self.L.matvec(y)
        x = self.inv_d * y
        for _ in range(sweeps):
            x = self.inv_d * (y - self.U.matvec(x))
        return x

    def matvec(self, x: jax.Array) -> jax.Array:
        """M x = L (U x) — used to warm-start right preconditioning."""
        ux = self.U.matvec(x) + self.d * x
        return ux + self.L.matvec(ux)


def ilu0_factorize(a: CSRMatrix, dtype=None) -> ILU0Preconditioner:
    """Host factorization (native C++ when available) -> device factors."""
    indptr = np.asarray(a.indptr, np.int64)
    cols = np.asarray(a.cols, np.int32)
    vals = np.asarray(a.vals, np.float64)
    fvals = ilu0_native(indptr, cols, vals)
    if fvals is None:
        fvals = _ilu0_numpy(indptr, cols, vals)
    dtype = dtype or a.vals.dtype
    L, U, d = _split_ell(indptr, cols, fvals, dtype)
    return ILU0Preconditioner(L=L, U=U, d=d, inv_d=1.0 / d)


def ilu0_solve_exact(a: CSRMatrix, b: np.ndarray) -> np.ndarray:
    """Exact host-side M^-1 b on the packed factors (validation path)."""
    indptr = np.asarray(a.indptr, np.int64)
    cols = np.asarray(a.cols, np.int32)
    vals = np.asarray(a.vals, np.float64)
    fvals = ilu0_native(indptr, cols, vals)
    if fvals is None:
        fvals = _ilu0_numpy(indptr, cols, vals)
    x = ilu0_solve_native(indptr, cols, fvals, np.asarray(b, np.float64))
    if x is not None:
        return x
    # numpy fallback: sequential substitution
    n = indptr.shape[0] - 1
    x = np.asarray(b, np.float64).copy()
    for i in range(n):
        for t in range(indptr[i], indptr[i + 1]):
            if cols[t] >= i:
                break
            x[i] -= fvals[t] * x[cols[t]]
    for i in range(n - 1, -1, -1):
        piv = 0.0
        for t in range(indptr[i], indptr[i + 1]):
            j = cols[t]
            if j > i:
                x[i] -= fvals[t] * x[j]
            elif j == i:
                piv = fvals[t]
        x[i] /= piv
    return x


# ----------------------------------------------------------------------
# Stencil-form ILU(0): the production path.
#
# The global matrix's nonzero pattern is a block stencil (assembly/
# stencil.py: shared 7-offset A blocks, gu/ku/da coupling fields), and
# ILU(0) by definition keeps that pattern — so the L and U factors are
# *themselves* stencil operators.  The factored values are extracted from
# the host CSR factorization back into coefficient fields and the
# triangular sweeps run as flat-roll streaming stencil applies (the same
# machinery as the forward operator) instead of per-row gathers, which
# turn every sweep into a gather over the whole state.
#
# Within-block invariance: eliminating an A row updates same-block entries
# only through same-block values (gu columns live in the U block and can
# never alias a block column), so the three A components factor to
# IDENTICAL block coefficients — one shared (7,)-field pair serves Ax/Ay/Az,
# exactly like the forward ka.  (Asserted against the CSR factors in
# tests/test_ilu0_stencil.py.)
#
# Column/row order inside the U block follows the reference's conducting
# numbering (PHYS_C order, vxc2data.f90:624-651), which need not be
# monotone in the flat cell index — each ku offset is therefore split
# entrywise into strict-lower/strict-upper by the actual global column
# comparison.  gu columns are always upper (3N + ... > any A row); da
# columns always lower (< 3N).
# ----------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StencilILU0:
    """ILU(0) factors as stencil operators on the State space.

    ``L_op``/``U_op`` are strict-triangular stencil operators (L has unit
    diagonal, held implicitly); ``inv_dA``/``inv_dU`` are the inverted
    U-factor diagonals (A blocks share one field)."""

    L_op: object          # strict lower
    U_op: object          # strict upper
    d_A: jax.Array        # (nz,ny,nx) U-factor diagonal, shared by Ax/Ay/Az
    d_U: jax.Array        # (nz,ny,nx) U-factor diagonal of U rows (1 off-cond)
    inv_dA: jax.Array
    inv_dU: jax.Array

    def _invd(self, s):
        from ..assembly.stencil import State
        return State(self.inv_dA[None] * s.A, self.inv_dU * s.U)

    def apply(self, v, sweeps: int = 2):
        """z ~= U^-1 L^-1 v via ``sweeps`` Jacobi sweeps per triangle
        (truncated Neumann series — fixed and linear, hence a legitimate
        stationary right preconditioner; see module docstring of the ELL
        tier above for the semantics argument)."""
        from ..assembly.stencil import State
        y = v
        for _ in range(sweeps):
            ly = self.L_op.apply(y)
            y = State(v.A - ly.A, v.U - ly.U)
        x = self._invd(y)
        for _ in range(sweeps):
            ux = self.U_op.apply(x)
            x = self._invd(State(y.A - ux.A, y.U - ux.U))
        return x

    def matvec(self, x):
        """M x = L (U x) — warm-start map for right preconditioning."""
        from ..assembly.stencil import State
        ux = self.U_op.apply(x)
        ux = State(ux.A + self.d_A[None] * x.A, ux.U + self.d_U * x.U)
        lux = self.L_op.apply(ux)
        return State(ux.A + lux.A, ux.U + lux.U)


def ilu0_stencil_factorize(system, model, dtype=None) -> "StencilILU0":
    """Host ILU(0) on the exported CSR, re-expressed as stencil fields.

    Everything stays on host numpy until the final device put — no
    device-to-host round trips of the multi-million-entry CSR."""
    from ..assembly.assemble import to_csr
    from ..assembly.stencil import OFFSETS7, StencilOperator

    dtype = dtype or jnp.float32
    csr = to_csr(system, model)
    csr.sort_indices()
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int32)
    fv = ilu0_native(indptr, cols, np.asarray(csr.data, np.float64))
    if fv is None:
        fv = _ilu0_numpy(indptr, cols, np.asarray(csr.data, np.float64))

    ntot = csr.shape[0]
    rows = np.repeat(np.arange(ntot, dtype=np.int64), np.diff(indptr))
    keys = rows * ntot + cols          # ascending (CSR + sorted columns)

    def lookup(r, c):
        want = r.astype(np.int64) * ntot + c
        idx = np.searchsorted(keys, want)
        # unconditional (assert would vanish under python -O): a mask or
        # ordering bug here would otherwise silently extract wrong factor
        # values — e.g. u_col = 3N + condno - 1 evaluates to a *valid* A
        # column (3N - 1) on non-conducting cells
        if not np.array_equal(keys[np.clip(idx, 0, len(keys) - 1)], want):
            raise ValueError(
                "ILU(0) pattern mismatch during stencil extraction: a "
                "requested (row, col) entry is absent from the CSR pattern")
        return fv[idx]

    nz, ny, nx = system.shape_zyx
    shape = (nz, ny, nx)
    N = nx * ny * nz
    flat = np.arange(N, dtype=np.int64)
    stride = {0: 1, 1: nx, 2: nx * ny}
    condno = model.cond_number.ravel().astype(np.int64)

    def u_col(cells):
        """Global U column of flat cells; refuses non-conducting cells
        (where 3N + condno - 1 would alias the valid A column 3N - 1)."""
        cn = condno[cells]
        if (cn <= 0).any():
            raise ValueError(
                "ILU(0) stencil extraction requested the U column of a "
                "non-conducting cell")
        return 3 * N + cn - 1

    # --- A blocks: extract from block 0 (shared across components) ---
    kaF = np.zeros((7, N))
    for o, (axis, d) in enumerate(OFFSETS7):
        keep = system.np_ka[o].ravel() != 0.0
        tgt = flat if d == 0 else flat + d * stride[axis]
        kaF[o, keep] = lookup(flat[keep], tgt[keep])
    kaL = np.zeros((7,) + shape)
    kaU = np.zeros((7,) + shape)
    for o in (1, 3, 5):                # minus offsets: col < row
        kaL[o] = kaF[o].reshape(shape)
    for o in (2, 4, 6):                # plus offsets: col > row
        kaU[o] = kaF[o].reshape(shape)
    d_A = kaF[0].reshape(shape)

    # --- gu: A-row -> U-column coupling, always strict upper ---
    guU = np.zeros((3, 5) + shape)
    for c in range(3):
        for k, d in enumerate((-2, -1, 0, +1, +2)):
            keep = system.np_gu[c, k].ravel() != 0.0
            tgt = np.clip(flat + d * stride[c], 0, N - 1)
            guU[c, k].reshape(N)[keep] = lookup(
                c * N + flat[keep], u_col(tgt[keep]))

    # --- da: U-row -> A-column coupling, always strict lower ---
    daL = np.zeros((3, 3) + shape)
    for c in range(3):
        for k, d in enumerate((-1, 0, +1)):
            keep = system.np_da[c, k].ravel() != 0.0
            tgt = np.clip(flat + d * stride[c], 0, N - 1)
            daL[c, k].reshape(N)[keep] = lookup(
                u_col(flat[keep]), c * N + tgt[keep])

    # --- ku: split per entry by the conducting-number order ---
    kuL = np.zeros((7,) + shape)
    kuU = np.zeros((7,) + shape)
    d_U = np.ones(shape)
    keep0 = system.np_ku[0].ravel() != 0.0
    uc0 = u_col(np.nonzero(keep0)[0])
    d_U.reshape(N)[keep0] = lookup(uc0, uc0)
    for o, (axis, d) in enumerate(OFFSETS7):
        if o == 0:
            continue
        keep = system.np_ku[o].ravel() != 0.0
        tgt = np.clip(flat + d * stride[axis], 0, N - 1)
        r, c = u_col(np.nonzero(keep)[0]), u_col(tgt[keep])
        vals = lookup(r, c)
        lower = c < r
        tmpL = np.zeros(N); tmpU = np.zeros(N)
        idx = np.nonzero(keep)[0]
        tmpL[idx[lower]] = vals[lower]
        tmpU[idx[~lower]] = vals[~lower]
        kuL[o] = tmpL.reshape(shape)
        kuU[o] = tmpU.reshape(shape)

    # box restriction (same window as the forward operator)
    box = system.op.box
    if box is not None:
        z0, z1, y0, y1, x0, x1 = box
        bsl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        gu_b = guU[(slice(None), slice(None)) + bsl]
        kuL_b = kuL[(slice(None),) + bsl]
        kuU_b = kuU[(slice(None),) + bsl]
        da_b = daL[(slice(None), slice(None)) + bsl]
    else:
        gu_b = np.zeros((3, 5, 0, 0, 0))
        kuL_b = kuU_b = np.zeros((7, 0, 0, 0))
        da_b = np.zeros((3, 3, 0, 0, 0))

    zero_gu = np.zeros_like(gu_b)
    zero_da = np.zeros_like(da_b)
    L_op = StencilOperator(
        ka=jnp.asarray(kaL, dtype), gu=jnp.asarray(zero_gu, dtype),
        ku=jnp.asarray(kuL_b, dtype), da=jnp.asarray(da_b, dtype), box=box)
    U_op = StencilOperator(
        ka=jnp.asarray(kaU, dtype), gu=jnp.asarray(gu_b, dtype),
        ku=jnp.asarray(kuU_b, dtype), da=jnp.asarray(zero_da, dtype), box=box)
    d_Aj = jnp.asarray(d_A, dtype)
    d_Uj = jnp.asarray(d_U, dtype)
    return StencilILU0(
        L_op=L_op, U_op=U_op, d_A=d_Aj, d_U=d_Uj,
        inv_dA=1.0 / d_Aj, inv_dU=1.0 / d_Uj)


def bicgstab_ilu0(a: CSRMatrix, b, x0, tol, itmax, sweeps: int = 4,
                  dot_dtype=None) -> SolveResult:
    """Right-ILU(0)-preconditioned BiCGSTABwr on a CSR system."""
    M = ilu0_factorize(a)
    minv = partial(M.apply, sweeps=sweeps)

    def wrapped(y):
        return a.matvec(minv(y))

    res = bicgstab_wr(wrapped, b, M.matvec(x0), tol, itmax, dot_dtype=dot_dtype)
    return SolveResult(x=minv(res.x), iterations=res.iterations,
                       relres=res.relres, converged=res.converged)
