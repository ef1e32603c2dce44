"""General sparse containers (CSR / COO / ELL) with device SpMV.

The simulation hot path uses the structured stencil operator
(assembly/stencil.py) — gather-free streaming work.  This module is the
*general* sparse tier the framework also provides: unstructured matrices
for interop, tests, and irregular couplings, stored as pytrees with jittable
SpMV.  The CSR product reproduces the semantics of the reference kernel
``sprsAx`` (solvers.f90:54-61).

On an accelerator, ELL (padded fixed-width rows) is the preferred general
layout: the gather of ``x[col]`` is the unavoidable cost, but
values/columns stream densely.  CSR SpMV is expressed as a segment-sum over
the COO expansion, which XLA lowers to scatter-adds.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CSRMatrix", "COOMatrix", "ELLMatrix", "BSRMatrix",
    "from_scipy", "bsr_from_scipy", "spgemm", "spgemm_plan", "SpGEMMPlan",
]


@dataclass(frozen=True)
class COOMatrix:
    rows: jax.Array
    cols: jax.Array
    vals: jax.Array
    shape: tuple[int, int]

    def matvec(self, x: jax.Array) -> jax.Array:
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(prod, self.rows, num_segments=self.shape[0])

    def matmat(self, x: jax.Array) -> jax.Array:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        prod = self.vals[:, None] * x[self.cols]
        return jax.ops.segment_sum(prod, self.rows, num_segments=self.shape[0])

    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.vals.dtype)
        return out.at[self.rows, self.cols].add(self.vals)


jax.tree_util.register_dataclass(
    COOMatrix, data_fields=["rows", "cols", "vals"], meta_fields=["shape"]
)


@dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse row; ``indptr`` (n+1,), ``cols``/``vals`` (nnz,)."""

    indptr: jax.Array
    cols: jax.Array
    vals: jax.Array
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.cols.shape[0]

    def row_lengths(self) -> jax.Array:
        return self.indptr[1:] - self.indptr[:-1]

    def row_ids(self) -> jax.Array:
        """Expand indptr to a per-nnz row index — traceable under jit
        (scatter a 1 at each row start, then prefix-sum)."""
        nnz = self.cols.shape[0]
        starts = jnp.zeros(nnz, jnp.int32).at[self.indptr[1:-1]].add(1)
        return jnp.cumsum(starts)

    def to_coo(self) -> COOMatrix:
        return COOMatrix(rows=self.row_ids(), cols=self.cols, vals=self.vals,
                         shape=self.shape)

    def matvec(self, x: jax.Array) -> jax.Array:
        """y[i] = sum_j vals[indptr[i]:indptr[i+1]] * x[cols[...]]
        (sprsAx semantics, solvers.f90:57-60)."""
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(prod, self.row_ids(), num_segments=self.shape[0])

    def matmat(self, x: jax.Array) -> jax.Array:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        prod = self.vals[:, None] * x[self.cols]
        return jax.ops.segment_sum(prod, self.row_ids(), num_segments=self.shape[0])

    def diagonal(self) -> jax.Array:
        """Main diagonal (rows with no stored diagonal contribute 0)."""
        hit = self.cols == self.row_ids()
        return jax.ops.segment_sum(
            jnp.where(hit, self.vals, 0.0), self.row_ids(),
            num_segments=self.shape[0])

    def todense(self) -> jax.Array:
        return self.to_coo().todense()

    def to_ell(self, width: int | None = None) -> "ELLMatrix":
        indptr = np.asarray(self.indptr)
        cols = np.asarray(self.cols)
        vals = np.asarray(self.vals)
        lens = np.diff(indptr)
        w = int(lens.max()) if width is None else width
        n = self.shape[0]
        ecols = np.zeros((n, w), cols.dtype)
        evals = np.zeros((n, w), vals.dtype)
        for i in range(n):
            k = lens[i]
            ecols[i, :k] = cols[indptr[i]:indptr[i] + k]
            evals[i, :k] = vals[indptr[i]:indptr[i] + k]
        return ELLMatrix(cols=jnp.asarray(ecols), vals=jnp.asarray(evals), shape=self.shape)


jax.tree_util.register_dataclass(
    CSRMatrix, data_fields=["indptr", "cols", "vals"], meta_fields=["shape"]
)


@dataclass(frozen=True)
class ELLMatrix:
    """Padded fixed-width rows: cols/vals are (n, width); padding has
    val == 0 (its column index is arbitrary but in range)."""

    cols: jax.Array
    vals: jax.Array
    shape: tuple[int, int]

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.vals * x[self.cols], axis=1)

    def matmat(self, x: jax.Array) -> jax.Array:
        """SpMM: ``A @ X`` for dense ``X`` of shape (n, k)."""
        return jnp.sum(self.vals[..., None] * x[self.cols], axis=1)


jax.tree_util.register_dataclass(
    ELLMatrix, data_fields=["cols", "vals"], meta_fields=["shape"]
)


@dataclass(frozen=True)
class BSRMatrix:
    """Block sparse row with padded fixed-width block rows ("block-ELL").

    Block-sparse layout: each logical row of ``width`` slots holds dense
    (R, C) blocks, so SpMV/SpMM are batched dense matmuls — the sparse
    structure only drives *which* x-block each slot reads.  Padding slots
    carry ``block_cols == 0`` and an all-zero block (in range, numerically
    inert).

    * ``block_cols``: (nbr, width) int32 block-column index per slot
    * ``blocks``:     (nbr, width, R, C) dense block values
    * ``shape``:      logical (nbr*R, nbc*C) element shape
    """

    block_cols: jax.Array
    blocks: jax.Array
    shape: tuple[int, int]

    @property
    def block_shape(self) -> tuple[int, int]:
        return tuple(self.blocks.shape[2:])

    @property
    def nnz(self) -> int:
        """Stored entries incl. padding (dense storage of each block)."""
        return int(np.prod(self.blocks.shape))

    def matvec(self, x: jax.Array) -> jax.Array:
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, x: jax.Array) -> jax.Array:
        """``A @ X`` for dense ``X`` (n, k): gather x-blocks per slot, then a
        batched (R, C) x (C, k) contraction — matrix-unit work, not scatter
        work."""
        nbr, w, R, C = self.blocks.shape
        xb = x.reshape(-1, C, x.shape[1])           # (nbc, C, k)
        gx = xb[self.block_cols]                     # (nbr, w, C, k)
        # contract C; batch over (nbr, w); sum slots.  HIGHEST keeps a
        # float32 product out of TF32, which would change the results
        y = jnp.einsum("rwij,rwjk->rik", self.blocks, gx,
                       preferred_element_type=self.blocks.dtype,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(nbr * R, x.shape[1])

    def todense(self) -> jax.Array:
        nbr, w, R, C = self.blocks.shape
        n, m = self.shape
        out = jnp.zeros((nbr, m // C, R, C), self.blocks.dtype)
        rows = jnp.arange(nbr)[:, None].repeat(w, 1)
        out = out.at[rows, self.block_cols].add(self.blocks)
        return out.transpose(0, 2, 1, 3).reshape(n, m)


jax.tree_util.register_dataclass(
    BSRMatrix, data_fields=["block_cols", "blocks"], meta_fields=["shape"]
)


def bsr_from_scipy(m, block_shape=(8, 8), dtype=jnp.float32) -> BSRMatrix:
    """Convert any scipy matrix to padded block-ELL BSR (host-side, once).

    The element grid is zero-padded up to block multiples; every block row
    is padded to the maximum block-row width."""
    import scipy.sparse as sp

    R, C = block_shape
    n, mcols = m.shape
    npad, mpad = -(-n // R) * R, -(-mcols // C) * C
    mb = sp.csr_matrix(m)
    mb.resize((npad, mpad))
    b = mb.tobsr(blocksize=(R, C))
    nbr = npad // R
    lens = np.diff(b.indptr)
    w = max(int(lens.max()) if nbr else 0, 1)
    bcols = np.zeros((nbr, w), np.int32)
    blocks = np.zeros((nbr, w, R, C), np.asarray(b.data).dtype)
    for i in range(nbr):
        k = lens[i]
        bcols[i, :k] = b.indices[b.indptr[i]:b.indptr[i] + k]
        blocks[i, :k] = b.data[b.indptr[i]:b.indptr[i] + k]
    return BSRMatrix(block_cols=jnp.asarray(bcols),
                     blocks=jnp.asarray(blocks, dtype),
                     shape=(npad, mpad))


# ---------------------------------------------------------------------------
# SpGEMM: C = A @ B for CSR A, B.
#
# Two-phase design: the *symbolic* phase (output structure and the
# multiset of scalar products feeding each output entry) runs on host once —
# it is pure integer bookkeeping with data-dependent shapes, which XLA cannot
# express; the *numeric* phase is a jittable static-shape gather +
# segment-sum, so repeated products with the same structure (e.g. re-assembly
# each timestep with changed values) run entirely on device.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpGEMMPlan:
    """Static product structure for ``C = A @ B``.

    ``a_idx``/``b_idx`` (npairs,): for each elementary product, the index
    into A.vals / B.vals.  ``out_idx`` (npairs,): the output nnz slot the
    product accumulates into.  ``indptr``/``cols``: the CSR structure of C.
    """

    a_idx: jax.Array
    b_idx: jax.Array
    out_idx: jax.Array
    indptr: jax.Array
    cols: jax.Array
    shape: tuple[int, int]

    def numeric(self, a_vals: jax.Array, b_vals: jax.Array) -> CSRMatrix:
        """Device phase: values of C from values of A and B (jittable)."""
        prod = a_vals[self.a_idx] * b_vals[self.b_idx]
        vals = jax.ops.segment_sum(prod, self.out_idx,
                                   num_segments=self.cols.shape[0])
        return CSRMatrix(indptr=self.indptr, cols=self.cols, vals=vals,
                         shape=self.shape)


jax.tree_util.register_dataclass(
    SpGEMMPlan,
    data_fields=["a_idx", "b_idx", "out_idx", "indptr", "cols"],
    meta_fields=["shape"],
)


def spgemm_plan(a: CSRMatrix, b: CSRMatrix) -> SpGEMMPlan:
    """Host symbolic phase (run once per structure)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {a.shape} @ {b.shape}")
    a_indptr = np.asarray(a.indptr); a_cols = np.asarray(a.cols)
    b_indptr = np.asarray(b.indptr); b_cols = np.asarray(b.cols)
    n = a.shape[0]

    # elementary products: for A entry t in row i with column j, pair with
    # every B entry of row j
    a_row = np.repeat(np.arange(n), np.diff(a_indptr))
    seg = b_indptr[a_cols + 1] - b_indptr[a_cols]          # products per A entry
    a_idx = np.repeat(np.arange(a_cols.shape[0]), seg)
    # b indices: for each A entry, the contiguous run b_indptr[j] ...
    starts = np.repeat(b_indptr[a_cols], seg)
    within = np.arange(seg.sum()) - np.repeat(np.cumsum(seg) - seg, seg)
    b_idx = starts + within
    out_row = np.repeat(a_row, seg)
    out_col = b_cols[b_idx]

    # dedupe (row, col) -> output slot, CSR-ordered
    key = out_row.astype(np.int64) * b.shape[1] + out_col
    uniq, out_idx = np.unique(key, return_inverse=True)
    c_rows = (uniq // b.shape[1]).astype(np.int64)
    c_cols = (uniq % b.shape[1]).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, c_rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)

    return SpGEMMPlan(
        a_idx=jnp.asarray(a_idx, jnp.int32),
        b_idx=jnp.asarray(b_idx, jnp.int32),
        out_idx=jnp.asarray(out_idx, jnp.int32),
        indptr=jnp.asarray(indptr),
        cols=jnp.asarray(c_cols),
        shape=(a.shape[0], b.shape[1]),
    )


def spgemm(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    """One-shot ``A @ B`` (symbolic on host + numeric on device)."""
    return spgemm_plan(a, b).numeric(a.vals, b.vals)


def from_scipy(m, dtype=jnp.float32) -> CSRMatrix:
    m = m.tocsr()
    return CSRMatrix(
        indptr=jnp.asarray(m.indptr, jnp.int32),
        cols=jnp.asarray(m.indices, jnp.int32),
        vals=jnp.asarray(m.data, dtype),
        shape=tuple(m.shape),
    )
