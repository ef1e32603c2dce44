"""Case-coded stencil operator: compute coefficients, don't stream them.

The field operator (assembly/stencil.py) streams its coefficients: 7
full-grid A-stencil fields plus 31 conductor-box coupling fields per
matvec.  But the assembled coefficients carry almost no information:

* the A-row stencil (EC3D.f90:528-663) is a *constant* 7-point stencil
  everywhere except (a) grid faces, where the closed-form BND multipliers
  apply — a pure function of the cell's face membership — and (b)
  conducting interior cells, which add the 2C/dt inertial diagonal and the
  ±C·Ve/(2Δ) convection pair;
* every U-coupling coefficient (the 27-way ladder, EC3D.f90:667-922) is a
  case-dependent constant — a function of the six "is this neighbor
  conducting" bits — times at most the cell's conductivity C.

So the coded operator keeps ONE int32 code field and ONE C field (plus
convection fields when a conductor moves) on the conductor box and
evaluates every coefficient from static constants inside the apply.  The
A stencil's face coefficients are per-axis vectors broadcast over the
grid; the decode is integer bit tests.  Both are elementwise, so XLA
fuses them into the stencil's consumers and the apply moves the state and
one code/C pair instead of the coefficient streams.

Correctness: the encoder *proves* itself against the assembly — it
reconstructs all four coefficient field sets from the code in f64 with the
same arithmetic expression forms as assembly/assemble.py and requires
bit-exact equality with ``system.np_*`` (including the reference's
(x-,y+,z+) corner sign quirk, EC3D.f90:803-806); any model it cannot
represent raises :class:`CodedUnsupported` and the caller keeps the field
operator.  Evaluating the same formulas in the state dtype can differ from
the host-f64-then-cast fields by ~1 ulp, far inside solver tolerance.

Box invariant (as for the field operator): the conductor box carries a
2-cell non-conducting halo (or ends at a grid face), and every code bit is
zero off the conductors, so zero-filled shifts inside the box are exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import jax
import jax.numpy as jnp
import numpy as np

from ..assembly.stencil import State, shift

__all__ = ["CodedStencilOperator", "from_assembled_coded", "CodedUnsupported"]

# code bits (1 = that neighbor is NOT conducting / out of grid)
_B_XM, _B_XP, _B_YM, _B_YP, _B_ZM, _B_ZP = 0, 1, 2, 3, 4, 5
_B_COND, _B_INTC = 6, 7


class CodedUnsupported(ValueError):
    """The model's assembled coefficients are not reproducible from the
    case code (raised defensively so callers can keep the field
    operator), or the model has no conductors."""


# ---------------------------------------------------------------------------
# host-side encode + proof
# ---------------------------------------------------------------------------

def _nb(cond, axis, d):
    """Neighbor-conducting mask, False beyond the grid (assemble._nshift)."""
    from ..assembly.assemble import _nshift
    return _nshift(cond, axis, d).astype(bool)


def _encode(model) -> np.ndarray:
    cond = model.cond_mask
    nz, ny, nx = model.shape_zyx
    code = np.zeros((nz, ny, nx), np.int32)
    for a, (bm, bp) in enumerate(((_B_XM, _B_XP), (_B_YM, _B_YP), (_B_ZM, _B_ZP))):
        code |= (~_nb(cond, a, -1)).astype(np.int32) << bm
        code |= (~_nb(cond, a, +1)).astype(np.int32) << bp
    on_face = np.zeros((nz, ny, nx), bool)
    on_face[:, :, 0] = on_face[:, :, -1] = True
    on_face[:, 0, :] = on_face[:, -1, :] = True
    on_face[0, :, :] = on_face[-1, :, :] = True
    code |= cond.astype(np.int32) << _B_COND
    code |= (cond & ~on_face).astype(np.int32) << _B_INTC
    # bits only matter on conducting cells (the decode multiplies by them)
    return np.where(cond, code, 0).astype(np.int32)


def _reconstruct(code: np.ndarray, Cf: np.ndarray, model, s, ds, dt,
                 inertia_on_faces: bool):
    """f64 reconstruction of (gu, ku, da) + the A-row diagonal deviation,
    mirroring assemble_operator's expression forms exactly."""
    shape = code.shape
    bit = lambda k: ((code >> k) & 1).astype(bool)
    mm = [bit(_B_XM), bit(_B_YM), bit(_B_ZM)]
    mp = [bit(_B_XP), bit(_B_YP), bit(_B_ZP)]
    cond = bit(_B_COND)
    intc = bit(_B_INTC)

    gu = np.zeros((3, 5) + shape)
    for c in range(3):
        one_m = intc & mp[c]
        one_p = intc & ~mp[c] & mm[c]
        central = intc & ~mp[c] & ~mm[c]
        g = Cf * ds[c]
        gu[c, 2] = np.where(one_m, -3.0 * g, np.where(one_p, 3.0 * g, 0.0))
        gu[c, 1] = np.where(one_m, 4.0 * g, np.where(central, g, 0.0))
        gu[c, 0] = np.where(one_m, -g, 0.0)
        gu[c, 3] = np.where(one_p, -4.0 * g, np.where(central, -g, 0.0))
        gu[c, 4] = np.where(one_p, g, 0.0)

    from ..assembly.assemble import _MOFF, _POFF
    ku = np.zeros((7,) + shape)
    ku[0] = np.where(cond, 2.0 * s.sum(), 0.0)
    for a in range(3):
        ku[_MOFF[a]] = np.where(
            cond, np.where(mp[a], -2.0 * s[a], np.where(mm[a], 0.0, -s[a])), 0.0)
        ku[_POFF[a]] = np.where(
            cond, np.where(mm[a], -2.0 * s[a], np.where(mp[a], 0.0, -s[a])), 0.0)

    da = np.zeros((3, 3) + shape)
    any_missing = (mm[0] | mp[0] | mm[1] | mp[1] | mm[2] | mp[2])
    interior13 = cond & ~any_missing
    quirk = cond & mm[0] & mp[1] & mp[2]     # EC3D.f90:803-806 sign quirk
    for a in range(3):
        big = 2.0 / (dt * model.delta[a])
        half = 0.5 / (dt * model.delta[a])
        sign = np.where(mp[a], 1.0, np.where(mm[a], -1.0, 0.0))
        if a == 0:
            sign = np.where(quirk, 1.0, sign)
        elif a == 1:
            sign = np.where(quirk, -1.0, sign)
        da[a, 1] = np.where(cond & (mm[a] | mp[a]), sign * big, 0.0)
        da[a, 0] = np.where(interior13, half, 0.0)
        da[a, 2] = np.where(interior13, -half, 0.0)

    inert_sel = cond if inertia_on_faces else intc
    diag_dev = np.where(inert_sel, 2.0 * Cf / dt, 0.0)
    return gu, ku, da, diag_dev


def _axis_coefs(n: int, s_a: float, bnd_a) -> tuple:
    """Closed-form A-stencil coefficients along one axis of length n:
    (minus-neighbor, plus-neighbor, diagonal share) — assemble_operator's
    face rule (open-boundary BND multipliers, EC3D.f90:528-643)."""
    at_m = np.zeros(n, bool)
    at_p = np.zeros(n, bool)
    at_m[0] = True
    at_p[-1] = True
    cm = np.where(at_m, 0.0, np.where(at_p, bnd_a[0] * s_a, -s_a))
    cp = np.where(at_p, 0.0, np.where(at_m, bnd_a[1] * s_a, -s_a))
    dg = np.where(at_m | at_p, s_a, 2.0 * s_a)
    return cm, cp, dg


def _closed_ka(model, s) -> np.ndarray:
    """The constant+face closed form of the A stencil (no conducting
    extras) as full-grid fields, for the proof."""
    from ..assembly.assemble import _MOFF, _POFF
    nz, ny, nx = model.shape_zyx
    BND = np.asarray(model.solver.BND, float)
    ka = np.zeros((7, nz, ny, nx))
    for a, n in enumerate((nx, ny, nz)):
        cm, cp, dg = _axis_coefs(n, s[a], BND[a])
        bshape = [1, 1, 1]
        bshape[2 - a] = n
        ka[_MOFF[a]] = np.broadcast_to(cm.reshape(bshape), (nz, ny, nx))
        ka[_POFF[a]] = np.broadcast_to(cp.reshape(bshape), (nz, ny, nx))
        ka[0] = ka[0] + dg.reshape(bshape)
    return ka


def from_assembled_coded(system, model,
                         inertia_on_faces: bool = False) -> "CodedStencilOperator":
    """Encode + prove.  Raises :class:`CodedUnsupported` when the assembled
    fields are not exactly reproducible from the code."""
    op = system.op
    dtype = op.ka.dtype
    dx, dy, dz = [float(d) for d in model.delta]
    s = np.array([1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2])
    ds = np.array([0.5 / dx, 0.5 / dy, 0.5 / dz])
    dt = float(model.tran.step)
    Cf = model.domain_field("C")

    code = _encode(model)
    gu, ku, da, diag_dev = _reconstruct(code, Cf, model, s, ds, dt,
                                        inertia_on_faces)

    # ---- proof: reconstruction must be bit-exact vs the assembly ----
    if not (np.array_equal(gu, system.np_gu) and
            np.array_equal(ku, system.np_ku) and
            np.array_equal(da, system.np_da)):
        raise CodedUnsupported("U-coupling fields not reproducible from code")
    # full A-stencil reconstruction with assembly's exact expression forms
    # (assemble.py:173-189): constant+face base, then convection on intc,
    # then the inertial diagonal
    from ..assembly.assemble import _MOFF, _POFF
    bitm = lambda k: ((code >> k) & 1).astype(bool)
    intc = bitm(_B_INTC)
    cond = bitm(_B_COND)
    inert_sel = cond if inertia_on_faces else intc
    recon = _closed_ka(model, s)
    Ve = [model.domain_field("VEX"), model.domain_field("VEY"),
          model.domain_field("VEZ")]
    conv = np.zeros((3,) + code.shape)
    for a in range(3):
        conv_a = Ve[a] / (2.0 * model.delta[a])
        recon[_MOFF[a]] = np.where(intc, recon[_MOFF[a]] - conv_a,
                                   recon[_MOFF[a]])
        recon[_POFF[a]] = np.where(intc, recon[_POFF[a]] + conv_a,
                                   recon[_POFF[a]])
        conv[a] = np.where(intc, conv_a, 0.0)
    inert = np.where(model.cond_mask, 2.0 * Cf / dt, 0.0)
    recon[0] = np.where(inert_sel, recon[0] + inert, recon[0])
    if not np.array_equal(recon, np.asarray(system.np_ka, np.float64)):
        raise CodedUnsupported("A-stencil fields not reproducible from code")
    has_conv = bool(np.any(conv))

    if op.box is None:
        raise CodedUnsupported("no conducting cells; use the field operator")
    z0, z1, y0, y1, x0, x1 = op.box
    bsl = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
    return CodedStencilOperator(
        code=jnp.asarray(code[bsl], jnp.int32),
        cf=jnp.asarray(Cf[bsl], dtype),
        conv=(jnp.asarray(conv[(slice(None),) + bsl], dtype) if has_conv
              else jnp.zeros((3, 0, 0, 0), dtype)),
        shape_zyx=tuple(int(v) for v in model.shape_zyx),
        box=tuple(int(v) for v in op.box),
        consts=(tuple(float(v) for v in s), tuple(float(v) for v in ds),
                dt, tuple(float(d) for d in model.delta),
                tuple(tuple(float(v) for v in row)
                      for row in np.asarray(model.solver.BND))),
        inertia_on_faces=bool(inertia_on_faces),
        has_conv=has_conv,
    )


# ---------------------------------------------------------------------------
# device-side evaluation
# ---------------------------------------------------------------------------

def _decode(code):
    bit = lambda k: ((code >> k) & 1) == 1
    mm = (bit(_B_XM), bit(_B_YM), bit(_B_ZM))
    mp = (bit(_B_XP), bit(_B_YP), bit(_B_ZP))
    return mm, mp, bit(_B_COND), bit(_B_INTC)


def _closed_stencil(consts, A):
    """Constant+face A stencil on the full grid: each axis's coefficients
    are length-n vectors broadcast along the other two axes."""
    s, _, _, _, BND = consts
    nz, ny, nx = A.shape[-3:]
    dtype = A.dtype
    yA = None
    diag = None
    for a, n in enumerate((nx, ny, nz)):
        cm, cp, dg = _axis_coefs(n, s[a], BND[a])
        bshape = [1, 1, 1]
        bshape[2 - a] = n
        cm, cp, dg = (jnp.asarray(v.reshape(bshape), dtype) for v in (cm, cp, dg))
        term = cm * shift(A, a, -1) + cp * shift(A, a, +1)
        yA = term if yA is None else yA + term
        diag = dg if diag is None else diag + dg
    return yA + diag * A


def _grad_u(consts, inertia_on_faces, has_conv, dec, cf, conv, Ub, Ab):
    """grad-U into the A rows (EC3D.f90:667-710) plus the conducting A-row
    extras (inertia, convection), on the box."""
    s, ds, dt, delta, _ = consts
    mm, mp, cond, intc = dec
    c = lambda v: jnp.asarray(v, Ub.dtype)
    zero = jnp.zeros_like(Ub)
    inert_sel = cond if inertia_on_faces else intc
    inert = jnp.where(inert_sel, c(2.0 / dt) * cf, zero)
    gout = []
    for comp in range(3):
        one_m = intc & mp[comp]
        one_p = intc & ~mp[comp] & mm[comp]
        central = intc & ~mp[comp] & ~mm[comp]
        g = cf * c(ds[comp])
        gc = (jnp.where(one_m, c(-3.0) * g, jnp.where(one_p, c(3.0) * g, zero)) * Ub
              + jnp.where(one_m, c(4.0) * g, jnp.where(central, g, zero)) * shift(Ub, comp, -1)
              + jnp.where(one_m, -g, zero) * shift(Ub, comp, -2)
              + jnp.where(one_p, c(-4.0) * g, jnp.where(central, -g, zero)) * shift(Ub, comp, +1)
              + jnp.where(one_p, g, zero) * shift(Ub, comp, +2))
        gc = gc + inert * Ab[comp]
        if has_conv:
            # the assembled convection pair ±Ve_a/(2Δ_a) lives in the
            # shared A stencil (assemble.py:184-186): row comp gains
            # Σ_a conv_a·(A_comp(+a) − A_comp(−a))
            for a in range(3):
                gc = gc + conv[a] * (shift(Ab[comp], a, +1)
                                     - shift(Ab[comp], a, -1))
        gout.append(gc)
    return jnp.stack(gout)


def _u_lap(consts, dec, Ub):
    """U-row case-coded Laplacian on U (EC3D.f90:766-921)."""
    s = consts[0]
    mm, mp, cond, _ = dec
    c = lambda v: jnp.asarray(v, Ub.dtype)
    zero = jnp.zeros_like(Ub)
    yu = jnp.where(cond, c(2.0 * (s[0] + s[1] + s[2])), zero) * Ub
    for a in range(3):
        km = jnp.where(mp[a], c(-2.0 * s[a]), jnp.where(mm[a], zero, c(-s[a])))
        kp = jnp.where(mm[a], c(-2.0 * s[a]), jnp.where(mp[a], zero, c(-s[a])))
        yu = yu + jnp.where(cond, km, zero) * shift(Ub, a, -1)
        yu = yu + jnp.where(cond, kp, zero) * shift(Ub, a, +1)
    return yu


def _div_row(consts, dec, Ab):
    """U-row div(dA/dt) coupling into A (EC3D.f90:766-922), on the box."""
    _, _, dt, delta, _ = consts
    mm, mp, cond, _ = dec
    c = lambda v: jnp.asarray(v, Ab.dtype)
    zero = jnp.zeros_like(Ab[0])
    any_missing = (mm[0] | mp[0] | mm[1] | mp[1] | mm[2] | mp[2])
    interior13 = cond & ~any_missing
    quirk = cond & mm[0] & mp[1] & mp[2]   # EC3D.f90:803-806 sign quirk
    yu = zero
    for a in range(3):
        big = c(2.0 / (dt * delta[a]))
        half = c(0.5 / (dt * delta[a]))
        sign = jnp.where(mp[a], big, jnp.where(mm[a], -big, zero))
        if a == 0:
            sign = jnp.where(quirk, big, sign)
        elif a == 1:
            sign = jnp.where(quirk, -big, sign)
        yu = yu + jnp.where(cond & (mm[a] | mp[a]), sign, zero) * Ab[a]
        yu = yu + jnp.where(interior13, half, zero) * shift(Ab[a], a, -1)
        yu = yu + jnp.where(interior13, -half, zero) * shift(Ab[a], a, +1)
    return yu


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CodedStencilOperator:
    """The assembled operator with its coefficients computed in the apply.

    Same surface as :class:`StencilOperator` on the solve path (``apply``,
    ``apply_div``), on the same unpadded grid."""

    code: jax.Array                 # (bz, by, bx) int32 case code on the box
    cf: jax.Array                   # (bz, by, bx) conductivity C on the box
    conv: jax.Array                 # (3, bz, by, bx) or (3, 0, 0, 0)
    shape_zyx: tuple = dc_field(metadata=dict(static=True))
    # (z0, z1, y0, y1, x0, x1) conductor box incl. its 2-cell halo
    box: tuple = dc_field(metadata=dict(static=True))
    consts: tuple = dc_field(metadata=dict(static=True), default=())
    inertia_on_faces: bool = dc_field(metadata=dict(static=True), default=False)
    has_conv: bool = dc_field(metadata=dict(static=True), default=False)

    def _sl(self):
        z0, z1, y0, y1, x0, x1 = self.box
        return (slice(z0, z1), slice(y0, y1), slice(x0, x1))

    def apply(self, x: State) -> State:
        """y = A @ x (the full coupled operator)."""
        sl = self._sl()
        dec = _decode(self.code)
        Ab = x.A[(slice(None),) + sl]
        Ub = x.U[sl]
        gout = _grad_u(self.consts, self.inertia_on_faces, self.has_conv,
                       dec, self.cf, self.conv, Ub, Ab)
        yA = _closed_stencil(self.consts, x.A)
        yA = yA.at[(slice(None),) + sl].add(gout)
        yu = _u_lap(self.consts, dec, Ub) + _div_row(self.consts, dec, Ab)
        yU = jnp.zeros_like(x.U).at[sl].set(yu)
        return State(yA, yU)

    def apply_div(self, A: jax.Array) -> jax.Array:
        """Only the U-row -> A-column coupling (the per-step RHS term,
        EC3D.f90:385-392)."""
        sl = self._sl()
        yu = _div_row(self.consts, _decode(self.code), A[(slice(None),) + sl])
        return jnp.zeros(A.shape[1:], A.dtype).at[sl].set(yu)
