"""Geometric multigrid preconditioner for the A-block stencil operator.

The reference is unpreconditioned (solvers.f90); the solver is bound by
memory traffic per matvec, so the lever beside a cheaper matvec is the
iteration count — which for the Poisson-dominated A-blocks (7-point Laplacian
in air + 2C/dt mass on conductors, EC3D.f90:649-663) multigrid attacks
directly.

Construction:

* **Cell-centered coarsening with piecewise-constant transfer.**  P copies a
  coarse cell to its 2x2x2 children; R = P^T sums them.  For a 7-point fine
  stencil the Galerkin product R A P is again 7-point, so every level is the
  same coefficient-field stencil apply (jnp rolls -> XLA fusion).  Coarse coefficients are pure
  reshape-sums of the fine fields — no sparse matrices anywhere.
* **Damped-Jacobi smoothing** (omega = 2/3): elementwise, HBM-streaming,
  no sequential dependence.
* **Fixed V-cycle** (static recursion, fixed sweep counts, zero initial
  guess) => the preconditioner is a constant linear operator, legitimate for
  right-preconditioned BiCGSTAB (delta form keeps the reference's
  ``||b - A x|| / ||b|| < tol`` stopping rule intact).

The U block is handled by diagonal scaling inside the same State-space
preconditioner (the U-row Laplacian lives only on the conductor box and is
already well-conditioned relative to the A/U scale disparity).

Semantics note: the grid-boundary rows (open-boundary BND multipliers,
EC3D.f90:528-643) and the conductor one-sided stencils are *in* the fine
coefficients; coarse levels approximate them, which is fine for a
preconditioner — the outer Krylov iteration owns correctness.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["build_mg", "MGPreconditioner", "galerkin_coarsen",
           "stencil7_apply"]

_W = 2.0 / 3.0          # damped-Jacobi weight

def stencil7_apply(ka: jax.Array, x: jax.Array) -> jax.Array:
    """y = A x for the 7-offset coefficient fields ``ka`` (7, nz, ny, nx)
    and ``x`` (..., nz, ny, nx).  Flat-roll formulation (wrapped entries are
    killed by zero boundary coefficients, same invariant as
    assembly/stencil.py)."""
    nz, ny, nx = ka.shape[1:]
    N = nz * ny * nx
    lead = x.shape[:-3]
    x2 = x.reshape(lead + (N,))
    k2 = ka.reshape(7, N)
    strides = (1, nx, nx * ny)
    y = k2[0] * x2
    # offsets: (axis, direction): 1 -x, 2 +x, 3 -y, 4 +y, 5 -z, 6 +z
    for o, (ax, d) in ((1, (0, -1)), (2, (0, +1)), (3, (1, -1)),
                       (4, (1, +1)), (5, (2, -1)), (6, (2, +1))):
        y = y + k2[o] * jnp.roll(x2, -d * strides[ax], axis=-1)
    return y.reshape(x.shape)


def _pad_even(a: np.ndarray) -> np.ndarray:
    """Zero-pad the trailing 3 dims of a coefficient field to even sizes.
    Padding rows have all-zero coefficients: they decouple exactly."""
    pz, py, px = (s % 2 for s in a.shape[-3:])
    if not (pz or py or px):
        return a
    pad = [(0, 0)] * (a.ndim - 3) + [(0, pz), (0, py), (0, px)]
    return np.pad(a, pad)


def galerkin_coarsen(ka: np.ndarray) -> np.ndarray:
    """Coarse 7-point coefficients KA = R A P for piecewise-constant P
    (copy to 2x2x2 children) and R = P^T (sum over children).

    Cross-coarse-cell couplings sum the 4 fine couplings crossing each
    coarse face; the coarse diagonal sums the 8 fine diagonals plus the 12
    internal fine couplings absorbed into the block.
    """
    ka = _pad_even(np.asarray(ka))
    nz, ny, nx = ka.shape[1:]
    Z, Y, X = nz // 2, ny // 2, nx // 2
    v = ka.reshape(7, Z, 2, Y, 2, X, 2)
    # v[o] axes: (Z, z2, Y, y2, X, x2) = (0, 1, 2, 3, 4, 5)

    def child(o, axis, idx):
        """Sum v[o] over the children on one side of a pair axis
        (axis: 1 = z-child, 3 = y-child, 5 = x-child)."""
        w = np.take(v[o], idx, axis=axis)
        # after take, the remaining child axes of (Z,*,Y,*,X,*) sit at:
        remaining = {1: (2, 4), 3: (1, 4), 5: (1, 3)}[axis]
        return w.sum(remaining)

    out = np.zeros((7, Z, Y, X), ka.dtype)
    out[1] = child(1, 5, 0)          # -x: fine -x couplings of x-low children
    out[2] = child(2, 5, 1)          # +x
    out[3] = child(3, 3, 0)          # -y
    out[4] = child(4, 3, 1)          # +y
    out[5] = child(5, 1, 0)          # -z
    out[6] = child(6, 1, 1)          # +z
    # diagonal: all 8 fine diagonals + the 12 internal fine couplings
    out[0] = (v[0].sum((1, 3, 5))
              + child(2, 5, 0) + child(1, 5, 1)      # internal x pairs
              + child(4, 3, 0) + child(3, 3, 1)      # internal y pairs
              + child(6, 1, 0) + child(5, 1, 1))     # internal z pairs
    return out


def _restrict(r: jax.Array) -> jax.Array:
    """R = P^T: sum 2x2x2 children (trailing dims must be even)."""
    s = r.shape
    Z, Y, X = s[-3] // 2, s[-2] // 2, s[-1] // 2
    return r.reshape(s[:-3] + (Z, 2, Y, 2, X, 2)).sum((-5, -3, -1))


def _prolong(e: jax.Array) -> jax.Array:
    """P: copy each coarse value to its 2x2x2 children."""
    s = e.shape
    out = jnp.broadcast_to(
        e[..., :, None, :, None, :, None],
        s[:-3] + (s[-3], 2, s[-2], 2, s[-1], 2),
    )
    return out.reshape(s[:-3] + (2 * s[-3], 2 * s[-2], 2 * s[-1]))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MGLevel:
    ka: jax.Array          # (7, nz, ny, nx)
    inv_d: jax.Array       # 1 / diag with zero-diag (decoupled) rows -> 1
    shape: tuple = dc_field(metadata=dict(static=True))       # unpadded shape
    pshape: tuple = dc_field(metadata=dict(static=True))      # even-padded


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MGPreconditioner:
    """V-cycle preconditioner on the shared A-block stencil; the full
    State-space apply() adds diagonal scaling for U (see module docstring)."""

    levels: tuple          # tuple[MGLevel, ...], fine -> coarse
    inv_du: jax.Array      # full-grid 1/diag for the U rows (1 off-conductor)
    pre: int = dc_field(metadata=dict(static=True), default=1)
    post: int = dc_field(metadata=dict(static=True), default=1)
    coarse_sweeps: int = dc_field(metadata=dict(static=True), default=12)

    # -- scalar-field V-cycle ------------------------------------------
    def _smooth(self, lvl: MGLevel, b, x, sweeps):
        for _ in range(sweeps):
            x = x + _W * lvl.inv_d * (b - stencil7_apply(lvl.ka, x))
        return x

    def _vcycle(self, li: int, b):
        lvl = self.levels[li]
        x = _W * lvl.inv_d * b            # first smoother sweep from x = 0
        if li == len(self.levels) - 1:
            return self._smooth(lvl, b, x, self.coarse_sweeps - 1)
        x = self._smooth(lvl, b, x, self.pre - 1)
        r = b - stencil7_apply(lvl.ka, x)
        # pad to even, restrict, recurse, prolong, crop
        pz, py, px = (p - s for p, s in zip(lvl.pshape, lvl.shape))
        rp = jnp.pad(r, [(0, 0)] * (r.ndim - 3) + [(0, pz), (0, py), (0, px)])
        ec = self._vcycle(li + 1, _restrict(rp))
        ep = _prolong(ec)[..., :lvl.shape[0], :lvl.shape[1], :lvl.shape[2]]
        x = x + ep
        return self._smooth(lvl, b, x, self.post)

    def apply_scalar(self, r: jax.Array) -> jax.Array:
        """M^-1 r for one scalar field on the fine grid (batched over
        leading dims by the stencil apply)."""
        return self._vcycle(0, r)

    def apply(self, v):
        """State-space M^-1: V-cycle on each A component, diagonal on U."""
        from ..assembly.stencil import State
        return State(self.apply_scalar(v.A), self.inv_du * v.U)


def build_mg(ka, ku0=None, min_dim: int = 4, max_levels: int = 10,
             pre: int = 1, post: int = 1, coarse_sweeps: int = 12,
             dtype=None) -> MGPreconditioner:
    """Build the V-cycle hierarchy from fine A coefficients ``ka``
    (7, nz, ny, nx) and optional U-row diagonal field ``ku0`` (nz, ny, nx;
    zeros off-conductor)."""
    ka_np = np.asarray(ka, np.float64)
    dtype = dtype or jnp.asarray(ka).dtype

    levels = []
    cur = ka_np
    for _ in range(max_levels):
        shape = cur.shape[1:]
        pshape = tuple(s + (s % 2) for s in shape)
        d = cur[0]
        inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        levels.append(MGLevel(
            ka=jnp.asarray(cur, dtype),
            inv_d=jnp.asarray(inv_d, dtype),
            shape=shape, pshape=pshape,
        ))
        if min(shape) < min_dim:
            break
        cur = galerkin_coarsen(cur)

    if ku0 is None:
        inv_du = jnp.ones(levels[0].shape, dtype)
    else:
        ku0 = np.asarray(ku0, np.float64)
        inv_du = jnp.asarray(
            np.where(ku0 != 0, 1.0 / np.where(ku0 == 0, 1.0, ku0), 1.0), dtype)

    return MGPreconditioner(levels=tuple(levels), inv_du=inv_du,
                            pre=pre, post=post, coarse_sweeps=coarse_sweeps)
