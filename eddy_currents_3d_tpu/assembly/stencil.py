"""Block stencil (DIA) operator — the device form of the global matrix.

The reference assembles one global CSR matrix over unknowns
``[Ax | Ay | Az | U]`` (EC3D.f90:465-1049) and applies it with a gather-based
SpMV (solvers.f90:54-61).  Gathers waste an accelerator's memory bandwidth,
so here the same linear operator is stored as *dense per-offset
coefficient fields* over the voxel grid and applied as a fused sum of
shifted multiply-adds — a pure streaming computation that XLA fuses into a
few passes and that shards trivially over a device mesh (z-slab sharding;
the shifts along z become collective permutes).

Blocks (see assemble.py for how they are filled):

* ``ka``  (7, nz, ny, nx)  — the A-row stencil, *shared* by Ax/Ay/Az
  (the reference uses identical rows for the three components,
  EC3D.f90:645-665).  Offset order: [0, -x, +x, -y, +y, -z, +z].
* ``gu``  (3, 5, *box*)    — grad-U coupling into the A_c row; offsets
  [-2, -1, 0, +1, +2] along axis c (central or one-sided (-3,+4,-1)
  conductor-surface stencils, EC3D.f90:667-710).
* ``ku``  (7, *box*)       — U-row Laplacian on U (EC3D.f90:766-921).
* ``da``  (3, 3, *box*)    — U-row div(dA/dt) coupling into A_c; offsets
  [-1, 0, +1] along axis c (EC3D.f90:918-921 plus the boundary-case
  same-cell couplings).

Bandwidth optimization: every U-coupled coefficient is nonzero only on
conducting cells, so ``gu``/``ku``/``da`` are stored restricted to the
conductor bounding box expanded by the stencil halo (2 cells) — for typical
models this removes most of the coefficient HBM traffic per matvec.  The
``box`` tuple is static metadata; an empty box means "no conductors".

U is stored dense on the grid but only conducting cells carry unknowns; all
coefficients touching non-conducting U cells are zero by construction, so
BiCGSTAB on the dense state is exactly the reference iteration on the
embedded CSR system (padding entries stay identically zero).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["State", "StencilOperator", "shift"]

# array axes for (..., z, y, x)
_AXIS = {0: -1, 1: -2, 2: -3}  # physical axis (x,y,z) -> array axis


def shift(f: jax.Array, axis: int, d: int) -> jax.Array:
    """Neighbor gather: ``out[c] = f[c + d * unit(axis)]``, zero beyond the
    grid.  ``axis`` is the physical axis (0=x, 1=y, 2=z); ``d`` static."""
    if d == 0:
        return f
    ax = _AXIS[axis] % f.ndim
    n = f.shape[ax]
    if abs(d) >= n:
        return jnp.zeros_like(f)
    src = [slice(None)] * f.ndim
    pad = [(0, 0)] * f.ndim
    if d > 0:
        src[ax] = slice(d, None)
        pad[ax] = (0, d)
    else:
        src[ax] = slice(None, d)
        pad[ax] = (-d, 0)
    return jnp.pad(f[tuple(src)], pad)


# canonical 7-point offset list used by ka/ku: index -> (axis, d)
OFFSETS7 = ((None, 0), (0, -1), (0, +1), (1, -1), (1, +1), (2, -1), (2, +1))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class State:
    """The unknown vector as grid fields: A (3, nz, ny, nx) and U (nz, ny, nx)."""

    A: jax.Array
    U: jax.Array

    # -- vector-space helpers --
    def __add__(self, o):  return State(self.A + o.A, self.U + o.U)
    def __sub__(self, o):  return State(self.A - o.A, self.U - o.U)
    def scale(self, a):    return State(a * self.A, a * self.U)
    def axpy(self, a, o):  return State(self.A + a * o.A, self.U + a * o.U)

    def dot(self, o) -> jax.Array:
        # sum-of-product, not vdot: vdot's ravel forces a full-state
        # all-gather under GSPMD sharding (see solvers/bicgstab.tree_dot)
        return jnp.sum(self.A * o.A) + jnp.sum(self.U * o.U)

    def norm(self) -> jax.Array:
        return jnp.sqrt(self.dot(self))

    @staticmethod
    def zeros(shape_zyx, dtype=jnp.float32) -> "State":
        nz, ny, nx = shape_zyx
        return State(jnp.zeros((3, nz, ny, nx), dtype), jnp.zeros((nz, ny, nx), dtype))


def _boxslice(box):
    z0, z1, y0, y1, x0, x1 = box
    return (slice(z0, z1), slice(y0, y1), slice(x0, x1))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StencilOperator:
    ka: jax.Array   # (7, nz, ny, nx)
    gu: jax.Array   # (3, 5, bz, by, bx) — conductor box (halo included)
    ku: jax.Array   # (7, bz, by, bx)
    da: jax.Array   # (3, 3, bz, by, bx)
    # (z0, z1, y0, y1, x0, x1) of the conductor box within the grid;
    # None when the model has no conducting cells
    box: Optional[tuple] = dc_field(metadata=dict(static=True), default=None)

    @property
    def shape_zyx(self):
        return self.ka.shape[1:]

    @property
    def dtype(self):
        return self.ka.dtype

    def apply(self, x: State) -> State:
        """y = A @ x (the full coupled operator).

        Flat-roll formulation: every stencil offset that crosses a grid (or
        conductor-box) face has a zero coefficient on the cells where the
        flattened roll would wrap (boundary rows drop the outward neighbor,
        EC3D.f90:528-643; one-sided conductor stencils sit >=2 cells inside
        the box), so shifts are plain ``jnp.roll`` on flat vectors — no
        padded 3-D intermediates, lane-aligned streaming."""
        nz, ny, nx = self.shape_zyx
        N = nz * ny * nx
        strides = (1, nx, nx * ny)

        A2 = x.A.reshape(3, N)
        ka = self.ka.reshape(7, N)
        yA = ka[0] * A2
        for o, (axis, d) in enumerate(OFFSETS7):
            if o == 0:
                continue
            yA = yA + ka[o] * jnp.roll(A2, -d * strides[axis], axis=1)

        if self.box is None:
            return State(yA.reshape(x.A.shape), jnp.zeros_like(x.U))

        sl = _boxslice(self.box)
        bz, by, bx = self.ku.shape[1:]
        B = bz * by * bx
        bstr = (1, bx, bx * by)
        Ub = x.U[sl].reshape(B)
        gu = self.gu.reshape(3, 5, B)
        ku = self.ku.reshape(7, B)

        # grad-U coupling into the A rows (conductor box only)
        gu_terms = []
        for c in range(3):
            t = gu[c, 2] * Ub
            for k, d in ((0, -2), (1, -1), (3, +1), (4, +2)):
                t = t + gu[c, k] * jnp.roll(Ub, -d * bstr[c])
            gu_terms.append(t.reshape(bz, by, bx))
        yA = yA.reshape(x.A.shape).at[(slice(None),) + sl].add(jnp.stack(gu_terms))

        # U rows: Laplacian on U + div coupling into A (box only)
        yUb = ku[0] * Ub
        for o, (axis, d) in enumerate(OFFSETS7):
            if o == 0:
                continue
            yUb = yUb + ku[o] * jnp.roll(Ub, -d * bstr[axis])
        yUb = yUb + self._div_box(x.A).reshape(B)
        yU = jnp.zeros_like(x.U).at[sl].set(yUb.reshape(bz, by, bx))
        return State(yA, yU)

    def _div_box(self, A: jax.Array) -> jax.Array:
        """Flat box vector of the div-coupling contraction (same flat-roll
        argument as apply: da is zero within 1 cell of the box faces)."""
        sl = _boxslice(self.box)
        bz, by, bx = self.ku.shape[1:]
        B = bz * by * bx
        bstr = (1, bx, bx * by)
        Ab = A[(slice(None),) + sl].reshape(3, B)
        da = self.da.reshape(3, 3, B)
        yUb = jnp.zeros(B, A.dtype)
        for c in range(3):
            yUb = yUb + da[c, 1] * Ab[c]
            yUb = yUb + da[c, 0] * jnp.roll(Ab[c], bstr[c])
            yUb = yUb + da[c, 2] * jnp.roll(Ab[c], -bstr[c])
        return yUb

    def apply_div(self, A: jax.Array) -> jax.Array:
        """Only the U-row -> A-column coupling (used for the per-step RHS:
        the reference moves these terms times the old solution to the right
        hand side, EC3D.f90:385-392).

        Note: the box slice of A sees true values (not zero padding), and
        off-box U rows have no coefficients, so this equals the full-grid
        contraction exactly."""
        full = jnp.zeros(A.shape[1:], A.dtype)
        if self.box is None:
            return full
        bz, by, bx = self.ku.shape[1:]
        return full.at[_boxslice(self.box)].set(self._div_box(A).reshape(bz, by, bx))

    def diagonal(self) -> State:
        """Operator diagonal as a State (for Jacobi preconditioning).
        Non-conducting U rows have no unknown; report 1 there."""
        dA = jnp.broadcast_to(self.ka[0][None], (3,) + tuple(self.ka.shape[1:]))
        dU = jnp.ones(self.ka.shape[1:], self.ka.dtype)
        if self.box is not None:
            ku0 = self.ku[0]
            dU = dU.at[_boxslice(self.box)].set(jnp.where(ku0 == 0, 1.0, ku0))
        return State(dA, dU)

    def astype(self, dtype) -> "StencilOperator":
        return StencilOperator(
            self.ka.astype(dtype), self.gu.astype(dtype),
            self.ku.astype(dtype), self.da.astype(dtype), self.box,
        )
