"""Restarted BiCGSTAB ("BiCGSTABwr") as a jittable `lax.while_loop`.

Algorithm and control flow match the reference solver exactly
(solvers.f90:3-63): unpreconditioned BiCGSTAB, convergence on
``||s||/||b|| < tol`` (half-step exit, solvers.f90:34-38) or
``||r||/||b|| < tol``, restart ``r0 = r; p = r`` when
``|r.r0_new|/||b|| < tol`` (solvers.f90:47-49), immediate return for a zero
right-hand side, and an iteration budget that performs ``itmax + 1``
iterations before giving up (the reference checks ``iter > itmax`` at the
top of the loop).  The solution vector is warm-started from ``x0`` — the
reference passes the previous timestep's solution in place (EC3D.f90:408).

Operands are arbitrary pytrees of arrays; dot products reduce over every
leaf (on a sharded mesh these become fused psum all-reduces inserted by
XLA).  All five reductions per iteration are batched into the minimum
number of dependency points the recurrence allows.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["bicgstab_wr", "bicgstab_wr_right", "bicgstab_jacobi",
           "tree_dot", "tree_norm", "tree_axpy", "SolveResult"]


def tree_dot(a, b, dtype=None):
    # sum-of-product, NOT jnp.vdot: vdot ravels its operands, and on
    # GSPMD-sharded state that reshape makes the partitioner all-gather
    # the FULL state every solver iteration (caught by the moving-source
    # shard tests); an elementwise multiply + reduce partitions into
    # per-shard partial sums + one fused all-reduce
    leaves = jax.tree.leaves(jax.tree.map(
        lambda x, y: jnp.sum((x.astype(dtype) if dtype else x)
                             * (y.astype(dtype) if dtype else y)), a, b))
    return sum(leaves[1:], leaves[0])


def tree_norm(a, dtype=None):
    return jnp.sqrt(tree_dot(a, a, dtype))


def tree_axpy(alpha, x, y):
    """y + alpha * x, leafwise.  ``alpha`` is cast to each leaf's dtype so
    higher-precision reduction scalars (dot_dtype) don't promote the
    iterate (the while_loop carry must keep the operand dtype, e.g. bf16
    state with f32 dots)."""
    return jax.tree.map(
        lambda xi, yi: yi + jnp.asarray(alpha, xi.dtype) * xi, x, y)


def _tree_sub(a, b):
    return jax.tree.map(jnp.subtract, a, b)


class SolveResult(NamedTuple):
    x: object            # solution pytree
    iterations: jax.Array
    relres: jax.Array    # last computed ||r||/||b|| (or ||s||/||b||)
    converged: jax.Array


class _Carry(NamedTuple):
    x: object
    r: object
    r0: object
    p: object
    # dot(r, r0), carried across iterations: the value the loop top would
    # recompute is bit-identical to what the previous iteration already
    # produced (rr0_new when not restarting, dot(r,r) == the norm's own
    # reduction on restart since r0 := r), so carrying it removes one
    # full-state reduction pass per iteration
    rr0: jax.Array
    it: jax.Array
    relres: jax.Array
    done: jax.Array


@partial(jax.jit, static_argnums=(0,), static_argnames=("dot_dtype",))
def bicgstab_wr(
    apply_fn: Callable,
    b,
    x0,
    tol,
    itmax,
    dot_dtype: Optional[jnp.dtype] = None,
) -> SolveResult:
    """Solve ``A x = b`` with restarted BiCGSTAB.

    ``apply_fn``: the matrix-vector product on the pytree space.
    ``dot_dtype``: accumulate reductions in this dtype (e.g. float64 on CPU
    validation runs); default = operand dtype.
    """
    dot = partial(tree_dot, dtype=dot_dtype)
    nrm = partial(tree_norm, dtype=dot_dtype)

    r = _tree_sub(b, apply_fn(x0))
    bnorm = nrm(b)
    zero_b = bnorm == 0.0

    def cond(c: _Carry):
        return jnp.logical_not(c.done) & (c.it <= itmax)

    def body(c: _Carry) -> _Carry:
        it = c.it + 1
        rr0 = c.rr0                       # == dot(c.r, c.r0), carried
        ap = apply_fn(c.p)
        ap_r0 = dot(ap, c.r0)
        alpha = rr0 / ap_r0
        s = tree_axpy(-alpha, ap, c.r)
        s_rel = nrm(s) / bnorm
        conv_s = s_rel < tol

        as_ = apply_fn(s)
        omega = dot(as_, s) / dot(as_, as_)
        # On the half-step exit the reference sets x += alpha*p only
        # (solvers.f90:34-38) and the loop terminates, so r/r0/p are dead
        # after this iteration: gating omega (and below beta) to 0 gives the
        # same x without any full-state selects.
        omega_g = jnp.where(conv_s, jnp.zeros_like(omega), omega)
        x_new = jax.tree.map(
            lambda xi, pi, si: (xi + jnp.asarray(alpha, xi.dtype) * pi
                                + jnp.asarray(omega_g, xi.dtype) * si),
            c.x, c.p, s,
        )
        r_new = tree_axpy(-omega_g, as_, s)
        rr = dot(r_new, r_new)
        r_rel = jnp.sqrt(rr) / bnorm
        conv_r = r_rel < tol

        rr0_new = dot(r_new, c.r0)
        # restart r0 = r; p = r (solvers.f90:47-49) == gating beta to 0 and
        # selecting r0; likewise a converged iteration's p/r0 are dead.
        restart = (jnp.abs(rr0_new) / bnorm) < tol
        beta = (alpha / omega) * rr0_new / rr0
        beta_g = jnp.where(restart | conv_s, jnp.zeros_like(beta), beta)
        omega_p = jnp.where(restart | conv_s, jnp.zeros_like(omega), omega)
        p_new = jax.tree.map(
            lambda ri, pi, api: ri + jnp.asarray(beta_g, ri.dtype)
            * (pi - jnp.asarray(omega_p, ri.dtype) * api), r_new, c.p, ap
        )
        r0_new = jax.tree.map(
            lambda ri, r0i: jnp.where(restart, ri, r0i), r_new, c.r0
        )
        return _Carry(
            x=x_new,
            r=r_new,
            r0=r0_new,
            p=p_new,
            # next iteration's dot(r, r0): on restart r0 := r, so it is
            # the freshly computed dot(r,r); otherwise rr0_new verbatim
            rr0=jnp.where(restart, rr, rr0_new),
            it=it,
            relres=jnp.where(conv_s, s_rel, r_rel),
            done=conv_s | conv_r,
        )

    init = _Carry(
        x=x0, r=r, r0=r, p=r,
        rr0=dot(r, r),                    # r0 == r at entry
        it=jnp.asarray(0, jnp.int32),
        relres=jnp.asarray(jnp.inf, bnorm.dtype),
        done=zero_b,
    )
    out = jax.lax.while_loop(cond, body, init)
    return SolveResult(x=out.x, iterations=out.it, relres=out.relres,
                       converged=out.done)


def bicgstab_jacobi(apply_fn, diag, b, x0, tol, itmax,
                    dot_dtype: Optional[jnp.dtype] = None) -> SolveResult:
    """Right-Jacobi-preconditioned BiCGSTABwr: solve ``(A D^-1) y = b`` with
    ``x = D^-1 y`` and warm start ``y0 = D x0`` — the residual history and
    convergence test remain those of the original system.  (The reference
    runs unpreconditioned, solvers.f90; this is the cheapest
    accelerator, also wired into Simulation as ``precond='jacobi'``.)"""
    inv = jax.tree.map(lambda d: 1.0 / d, diag)
    mul = lambda s, v: jax.tree.map(lambda a, b: a * b, s, v)
    res = bicgstab_wr(lambda v: apply_fn(mul(inv, v)), b, mul(diag, x0),
                      tol, itmax, dot_dtype=dot_dtype)
    return SolveResult(x=mul(inv, res.x), iterations=res.iterations,
                       relres=res.relres, converged=res.converged)


def bicgstab_wr_right(
    apply_fn: Callable,
    minv: Callable,
    b,
    x0,
    tol,
    itmax,
    dot_dtype: Optional[jnp.dtype] = None,
) -> SolveResult:
    """Right-preconditioned BiCGSTABwr in delta form for any linear
    ``minv ~= A^-1`` (Chebyshev, V-cycle, triangular sweeps, ...).

    Solves ``(A M^-1) dhat = b - A x0`` from zero and returns
    ``x = x0 + M^-1 dhat``; the inner tolerance is rescaled by
    ``||b|| / ||b - A x0||`` so the stop test remains exactly
    ``||b - A x|| / ||b|| < tol`` — the reference criterion
    (solvers.f90:34-43) — and converged solutions are interchangeable with
    unpreconditioned ones at the same tolerance."""
    wrapped = lambda v: apply_fn(minv(v))

    r0 = tree_axpy(-1.0, apply_fn(x0), b)
    bnorm = tree_norm(b, dot_dtype)
    rnorm = tree_norm(r0, dot_dtype)
    safe_r = jnp.where(rnorm == 0, 1.0, rnorm)
    safe_b = jnp.where(bnorm == 0, 1.0, bnorm)
    tol_eff = tol * bnorm / safe_r

    zero = jax.tree.map(jnp.zeros_like, b)
    res = bicgstab_wr(wrapped, r0, zero, tol_eff, itmax, dot_dtype=dot_dtype)
    x = jax.tree.map(jnp.add, x0, minv(res.x))
    already = rnorm <= tol * bnorm   # warm start already converged (or b=0)
    x = jax.tree.map(lambda xi, x0i: jnp.where(already, x0i, xi), x, x0)
    return SolveResult(
        x=x,
        iterations=jnp.where(already, 0, res.iterations),
        relres=jnp.where(already, rnorm / safe_b, res.relres * safe_r / safe_b),
        converged=already | res.converged,
    )
