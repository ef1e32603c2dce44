"""Chebyshev polynomial preconditioning for the Krylov solver.

An opt-in accelerator (the reference is unpreconditioned): ``M ~= A^-1`` is
the degree-k Chebyshev iteration for eigenvalues in ``[lmin, lmax]`` — pure
matvecs and axpys, no inner products, so it costs k-1 extra stencil
applications and zero reduction latency per outer iteration.  Applied as
*right* preconditioning in delta form, the BiCGSTAB stopping test remains
on the true residual of the original system relative to ``||b||`` — the
reference's exact criterion (solvers.f90:34-43) — so converged solutions
are interchangeable with unpreconditioned ones at the same tolerance.

``lmax`` comes from the Gershgorin bound of the assembled operator (for the
dominant 7-point block this is essentially 4*(sx+sy+sz), tight); ``lmin``
is ``lmax / ratio`` with a default ratio tuned on the reference TEAM7 case
(order 4, ratio 30: ~3.5x fewer outer iterations).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .bicgstab import SolveResult, bicgstab_wr, tree_axpy, tree_norm

__all__ = ["chebyshev_preconditioner", "bicgstab_wr_cheb"]


def chebyshev_preconditioner(apply_fn: Callable, order: int, lmin: float, lmax: float):
    """Returns M(r) ~= A^-1 r, the classic three-term Chebyshev recurrence
    with z0 = 0 (Saad, Iterative Methods, alg. 12.1)."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    def M(r):
        rho = 1.0 / sigma1
        d = jax.tree.map(lambda ri: ri / theta, r)
        z = d
        for _ in range(order - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            az = apply_fn(z)
            resid = jax.tree.map(jnp.subtract, r, az)
            d = jax.tree.map(
                lambda di, ri: (rho_new * rho) * di + (2.0 * rho_new / delta) * ri,
                d, resid,
            )
            z = jax.tree.map(jnp.add, z, d)
            rho = rho_new
        return z

    return M


def bicgstab_wr_cheb(
    apply_fn: Callable,
    b,
    x0,
    tol,
    itmax,
    *,
    order: int,
    lmin: float,
    lmax: float,
    dot_dtype=None,
) -> SolveResult:
    """Right-Chebyshev-preconditioned BiCGSTABwr in delta form.

    Solves ``(A M) dhat = b - A x0`` from zero, returns ``x = x0 + M dhat``.
    The inner tolerance is rescaled by ``||b|| / ||b - A x0||`` so the stop
    test is exactly ``||b - A x|| / ||b|| < tol`` (the reference criterion);
    the reported relres is re-expressed relative to ``||b||``.
    """
    M = chebyshev_preconditioner(apply_fn, order, lmin, lmax)
    wrapped = lambda v: apply_fn(M(v))

    r0 = tree_axpy(-1.0, apply_fn(x0), b)
    bnorm = tree_norm(b, dot_dtype)
    rnorm = tree_norm(r0, dot_dtype)
    safe_r = jnp.where(rnorm == 0, 1.0, rnorm)
    tol_eff = tol * bnorm / safe_r

    zero = jax.tree.map(jnp.zeros_like, b)
    res = bicgstab_wr(wrapped, r0, zero, tol_eff, itmax, dot_dtype=dot_dtype)
    x = jax.tree.map(jnp.add, x0, M(res.x))
    already = rnorm <= tol * bnorm   # warm start already converged (or b=0)
    x = jax.tree.map(lambda xi, x0i: jnp.where(already, x0i, xi), x, x0)
    return SolveResult(
        x=x,
        iterations=jnp.where(already, 0, res.iterations),
        relres=jnp.where(already, rnorm / jnp.where(bnorm == 0, 1.0, bnorm),
                         res.relres * safe_r / jnp.where(bnorm == 0, 1.0, bnorm)),
        converged=already | res.converged,
    )
