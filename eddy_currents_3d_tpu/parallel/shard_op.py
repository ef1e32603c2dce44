"""Explicit multi-device execution tier: `shard_map` + halo `ppermute`.

The GSPMD tier (parallel/mesh.py) lets the XLA partitioner slice the
flat-roll matvec; correct, but the partitioner must materialize whole-array
rotations as halo traffic it cannot overlap.  This module is the
hand-scheduled tier the reference has no analog of (it is single-threaded
Fortran, SURVEY §2 "no parallelism of any kind"): the voxel grid is
decomposed into z-slabs — and optionally y-columns, giving a full (z, y)
2-D decomposition for the reference's thin-z grids (TEAM7 is 102x102x24) —
over a device mesh.  Each device holds its block of every coefficient and
state field, and one matvec is

  1. ``ppermute`` the ±1 ghost A-planes and the ±2 ghost U-planes (box
     window only) to the z- and y-neighbors — started first so XLA's
     async collectives overlap them with the bulk compute;
  2. the shifted-multiply-add stencil on the local block with zero-filled
     shifts — the interior work, independent of the halos;
  3. cheap per-plane corrections adding the received ghost planes into the
     boundary planes of the local result.

Along z the ghost terms are pure adds: the zero-filled local shift left
nothing at a shard face.  Along y every coefficient slot that crosses an
internal y shard face is **zeroed at construction** (the saved rows ride
along as small per-shard face arrays), so the local stencil treats shard
faces exactly like true grid faces and the corrections are again pure
ghost adds.

Layout: z is padded to a multiple of the mesh's z extent (at least two
planes per shard, for the ±2 U halos) and y to ``n_y`` equal blocks;
padded planes carry zero coefficients and so stay identically zero through
BiCGSTAB.  The U-coupling fields keep the conductor-box (y, x) window —
the x window only on y-decomposed meshes — and span the full padded z,
since per-shard windows would give ragged shard shapes; only gu/ku/da pay
the inflation and they are the minor coefficient streams.

Solver dots/axpys run *outside* the shard_map at the GSPMD level, where an
elementwise op on sharded operands partitions trivially and a reduction
lowers to one fused psum all-reduce (solvers/bicgstab.py needs no changes).

Reference semantics being distributed: the CSR SpMV of solvers.f90:54-61
over the [Ax|Ay|Az|U] operator of EC3D.f90:465-1049.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..assembly.stencil import OFFSETS7, State, shift

__all__ = ["ShardedStencilOperator"]


def _pad_zyx(arr: np.ndarray, NZp: int, NYp: int, NXp: int) -> np.ndarray:
    pad = [(0, 0)] * (arr.ndim - 3) + [
        (0, NZp - arr.shape[-3]), (0, NYp - arr.shape[-2]), (0, NXp - arr.shape[-1])
    ]
    return np.pad(arr, pad)


@jax.tree_util.register_pytree_node_class
class ShardedStencilOperator:
    """(z, y)-sharded stencil operator with explicit halo exchange.

    A pytree whose leaves are the sharded coefficient arrays, so a jitted
    step takes them as arguments: arrays a jitted function closes over are
    lowered as constants, which at 256x256x64 puts gigabytes of
    coefficients into the executable."""

    _LEAVES = ("ka_p", "gu_p", "ku_p", "da_p", "_ka3f", "_ka4f",
               "_gm", "_gp", "_km", "_kp", "_dm", "_dp")

    def tree_flatten(self):
        names = tuple(n for n in self._LEAVES
                      if getattr(self, n, None) is not None)
        return tuple(getattr(self, n) for n in names), (self, names)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        # the aux part is the operator itself (compared by identity): its
        # static fields and the shard_map'd bodies, which read only those
        base, names = aux
        new = object.__new__(cls)
        new.__dict__.update(base.__dict__)
        new.__dict__.update(zip(names, leaves))
        return new

    def __init__(self, system, mesh: Mesh, dtype=jnp.float32,
                 coeff_dtype=None):
        self.mesh = mesh
        self.n_z = int(mesh.shape["z"])
        self.n_y = int(mesh.shape.get("y", 1))
        self.dtype = dtype
        self.coeff_dtype = coeff_dtype or dtype

        op = system.op
        nz, ny, nx = op.shape_zyx
        self.shape_zyx = (nz, ny, nx)
        # even splits only; each shard needs >= 2 local planes (z) and rows
        # (y) for the ±2 U halos to stay nearest-neighbor
        NYl = max(2, -(-ny // self.n_y))
        NYp = self.n_y * NYl
        self._NYl = NYl
        NZp = self.n_z * max(2, -(-nz // self.n_z))
        NXp = nx
        self.padded_zyx = (NZp, NYp, NXp)

        cd = self.coeff_dtype
        gspec = lambda ndim: NamedSharding(
            mesh, P(*([None] * (ndim - 3) + ["z", "y", None])))
        # coefficient streams in coeff_dtype (bf16 halves the dominant HBM
        # traffic); state stays in `dtype` (handled by pad_state/diagonal)
        put = lambda a: jax.device_put(jnp.asarray(a, cd), gspec(a.ndim))

        ka_h = _pad_zyx(np.asarray(system.np_ka, np.float64), NZp, NYp, NXp)

        if op.box is None:
            self.box = None
            self.gu_p = self.ku_p = self.da_p = None
        elif self.n_y == 1:
            # (y, x) conductor-box window (halo already included by
            # assemble_operator), full padded z extent
            _, _, y0, y1, x0, x1 = op.box

            def window(full: np.ndarray) -> np.ndarray:
                win = full[..., :, y0:y1, x0:x1]
                pad = [(0, 0)] * (full.ndim - 3) + [(0, NZp - nz), (0, 0), (0, 0)]
                return np.pad(win, pad)

            self.box = (y0, y1, x0, x1)
            gu_h = window(np.asarray(system.np_gu, np.float64))
            ku_h = window(np.asarray(system.np_ku, np.float64))
            da_h = window(np.asarray(system.np_da, np.float64))
        else:
            # y-decomposed mesh: x window only; full padded (z, y) extents
            _, _, _, _, x0, x1 = op.box

            def window(full: np.ndarray) -> np.ndarray:
                win = full[..., :, :, x0:x1]
                pad = [(0, 0)] * (full.ndim - 3) + [
                    (0, NZp - nz), (0, NYp - ny), (0, 0)]
                return np.pad(win, pad)

            self.box = (0, NYp, x0, x1)
            gu_h = window(np.asarray(system.np_gu, np.float64))
            ku_h = window(np.asarray(system.np_ku, np.float64))
            da_h = window(np.asarray(system.np_da, np.float64))

        if self.n_y > 1:
            # ---- internal y-face coefficient surgery (see module docstring)
            BXp_f = gu_h.shape[-1] if op.box is not None else 0
            ka3f = np.zeros((self.n_y, NZp, NXp))
            ka4f = np.zeros((self.n_y, NZp, NXp))
            gm = np.zeros((self.n_y, 3, NZp, BXp_f))
            gp = np.zeros((self.n_y, 3, NZp, BXp_f))
            km = np.zeros((self.n_y, NZp, BXp_f))
            kp = np.zeros((self.n_y, NZp, BXp_f))
            dm = np.zeros((self.n_y, NZp, BXp_f))
            dp = np.zeros((self.n_y, NZp, BXp_f))
            for k in range(1, self.n_y):
                r0, r1 = k * NYl, k * NYl + 1        # low rows of shard k
                e0, e1 = k * NYl - 1, k * NYl - 2    # high rows of shard k-1
                ka3f[k] = ka_h[3, :, r0, :]; ka_h[3, :, r0, :] = 0.0
                ka4f[k - 1] = ka_h[4, :, e0, :]; ka_h[4, :, e0, :] = 0.0
                if op.box is None:
                    continue
                gm[k, 0] = gu_h[1, 1, :, r0, :]; gu_h[1, 1, :, r0, :] = 0.0
                gm[k, 1] = gu_h[1, 0, :, r0, :]; gu_h[1, 0, :, r0, :] = 0.0
                gm[k, 2] = gu_h[1, 0, :, r1, :]; gu_h[1, 0, :, r1, :] = 0.0
                gp[k - 1, 0] = gu_h[1, 3, :, e0, :]; gu_h[1, 3, :, e0, :] = 0.0
                gp[k - 1, 1] = gu_h[1, 4, :, e0, :]; gu_h[1, 4, :, e0, :] = 0.0
                gp[k - 1, 2] = gu_h[1, 4, :, e1, :]; gu_h[1, 4, :, e1, :] = 0.0
                km[k] = ku_h[3, :, r0, :]; ku_h[3, :, r0, :] = 0.0
                kp[k - 1] = ku_h[4, :, e0, :]; ku_h[4, :, e0, :] = 0.0
                dm[k] = da_h[1, 0, :, r0, :]; da_h[1, 0, :, r0, :] = 0.0
                dp[k - 1] = da_h[1, 2, :, e0, :]; da_h[1, 2, :, e0, :] = 0.0
            yface = lambda a: jax.device_put(jnp.asarray(a, cd), NamedSharding(
                mesh, P(*(["y"] + [None] * (a.ndim - 3) + ["z", None]))))
            self._ka3f, self._ka4f = yface(ka3f), yface(ka4f)
            self._gm, self._gp = yface(gm), yface(gp)
            self._km, self._kp = yface(km), yface(kp)
            self._dm, self._dp = yface(dm), yface(dp)

        self.ka_p = put(ka_h)
        if op.box is not None:
            self.gu_p = put(gu_h)
            self.ku_p = put(ku_h)
            self.da_p = put(da_h)

        spec_a = P(None, "z", "y", None)
        spec_u = P("z", "y", None)
        spec_c5 = P(None, None, "z", "y", None)
        spec_f = P("y", "z", None)       # (n_y, NZp, ...) face arrays
        spec_f3 = P("y", None, "z", None)
        smap = partial(jax.shard_map, mesh=mesh)
        if self.box is None:
            extra = (spec_f, spec_f) if self.n_y > 1 else ()
            self._apply_sm = smap(
                self._local_apply_nobox,
                in_specs=(spec_a, spec_a) + extra,
                out_specs=(spec_a, spec_u))
        else:
            extra = ((spec_f, spec_f, spec_f3, spec_f3, spec_f, spec_f,
                      spec_f, spec_f) if self.n_y > 1 else ())
            self._apply_sm = smap(
                self._local_apply,
                in_specs=(spec_a, spec_c5, spec_a, spec_c5, spec_a, spec_u)
                + extra,
                out_specs=(spec_a, spec_u))
            dextra = (spec_f, spec_f) if self.n_y > 1 else ()
            self._div_sm = smap(
                self._local_div,
                in_specs=(spec_c5, spec_a) + dextra,
                out_specs=spec_u)

    # -- state padding: padded cells have zero coefficients, so they stay
    #    zero through BiCGSTAB and padding costs one pad/unpad per solve --
    def pad_state(self, x: State) -> State:
        nz, ny, nx = self.shape_zyx
        NZp, NYp, NXp = self.padded_zyx
        pad = [(0, NZp - nz), (0, NYp - ny), (0, NXp - nx)]
        return State(jnp.pad(x.A, [(0, 0)] + pad), jnp.pad(x.U, pad))

    def unpad_state(self, x: State) -> State:
        nz, ny, nx = self.shape_zyx
        return State(x.A[:, :nz, :ny, :nx], x.U[:nz, :ny, :nx])

    # ------------------------------------------------------------------
    def apply(self, x: State) -> State:
        """y = A @ x on padded, (z, y)-sharded fields."""
        if self.box is None:
            args = (self.ka_p, x.A)
            if self.n_y > 1:
                args += (self._ka3f, self._ka4f)
            yA, yU = self._apply_sm(*args)
        else:
            args = (self.ka_p, self.gu_p, self.ku_p, self.da_p, x.A, x.U)
            if self.n_y > 1:
                args += (self._ka3f, self._ka4f, self._gm, self._gp,
                         self._km, self._kp, self._dm, self._dp)
            yA, yU = self._apply_sm(*args)
        return State(yA, yU)

    def apply_div(self, A: jax.Array) -> jax.Array:
        """U-row div(dA/dt) contraction on the *unpadded* grid A — the
        per-step RHS term (EC3D.f90:385-392)."""
        nz, ny, nx = self.shape_zyx
        if self.box is None:
            return jnp.zeros(A.shape[1:], A.dtype)
        NZp, NYp, NXp = self.padded_zyx
        A_p = jnp.pad(A, [(0, 0), (0, NZp - nz), (0, NYp - ny), (0, NXp - nx)])
        args = (self.da_p, A_p)
        if self.n_y > 1:
            args += (self._dm, self._dp)
        return self._div_sm(*args)[:nz, :ny, :nx]

    # ------------------------------------------------------------------
    # per-shard bodies (called under shard_map; shapes are local blocks)
    # ------------------------------------------------------------------
    def _zperms(self):
        up = [(i, i + 1) for i in range(self.n_z - 1)]    # recv from below
        dn = [(i + 1, i) for i in range(self.n_z - 1)]    # recv from above
        return up, dn

    def _yperms(self):
        up = [(i, i + 1) for i in range(self.n_y - 1)]
        dn = [(i + 1, i) for i in range(self.n_y - 1)]
        return up, dn

    def _halo_a(self, A):
        """±1 ghost planes of A along z; zeros at the outer slabs (their
        face rows carry zero outward coefficients anyway)."""
        up, dn = self._zperms()
        a_lo = jax.lax.ppermute(A[:, -1], "z", up)
        a_hi = jax.lax.ppermute(A[:, 0], "z", dn)
        return a_lo, a_hi

    def _halo_a_y(self, A):
        """±1 ghost rows of A along y (y-decomposed meshes only)."""
        up, dn = self._yperms()
        a_ym = jax.lax.ppermute(A[:, :, -1, :], "y", up)
        a_yp = jax.lax.ppermute(A[:, :, 0, :], "y", dn)
        return a_ym, a_yp

    def _a_y_corr(self, yA, ka3f, ka4f, a_ym, a_yp):
        """Pure-add y-face ghost terms (face coefficients were zeroed)."""
        yA = yA.at[:, :, 0, :].add(ka3f[0][None] * a_ym)
        yA = yA.at[:, :, -1, :].add(ka4f[0][None] * a_yp)
        return yA

    def _local_apply_nobox(self, ka, A, ka3f=None, ka4f=None):
        a_lo, a_hi = self._halo_a(A)
        yA = self._a_block(ka, A, a_lo, a_hi)
        if self.n_y > 1:
            yA = self._a_y_corr(yA, ka3f, ka4f, *self._halo_a_y(A))
        return yA, jnp.zeros(A.shape[1:], A.dtype)

    def _local_apply(self, ka, gu, ku, da, A, U,
                     ka3f=None, ka4f=None, gm=None, gp=None,
                     km=None, kp=None, dm=None, dp=None):
        y0, y1, x0, x1 = self.box
        if self.n_y > 1:
            y0, y1 = 0, U.shape[1]   # box fields span the full local y
        up, dn = self._zperms()
        # halos first: XLA's async collective-permute overlaps them with the
        # halo-independent bulk kernels below
        a_lo, a_hi = self._halo_a(A)
        u_lo = jax.lax.ppermute(U[-2:, y0:y1, x0:x1], "z", up)  # [z-2, z-1]
        u_hi = jax.lax.ppermute(U[:2, y0:y1, x0:x1], "z", dn)   # [z+1, z+2]
        if self.n_y > 1:
            yup, ydn = self._yperms()
            a_ym, a_yp = self._halo_a_y(A)
            u_ym = jax.lax.ppermute(U[:, -2:, x0:x1], "y", yup)  # [y-2, y-1]
            u_yp = jax.lax.ppermute(U[:, :2, x0:x1], "y", ydn)   # [y+1, y+2]
            ay_m = jax.lax.ppermute(A[1, :, -1, x0:x1], "y", yup)
            ay_p = jax.lax.ppermute(A[1, :, 0, x0:x1], "y", ydn)

        yA = self._a_block(ka, A, a_lo, a_hi)

        Ub = U[:, y0:y1, x0:x1]
        Ab = A[:, :, y0:y1, x0:x1]
        ab_lo = a_lo[:, y0:y1, x0:x1]
        ab_hi = a_hi[:, y0:y1, x0:x1]

        # zero-fill shifts, ghost contributions are adds
        gt = []
        for c in range(3):
            t = gu[c, 2] * Ub
            for k, d in ((0, -2), (1, -1), (3, +1), (4, +2)):
                t = t + gu[c, k] * shift(Ub, c, d)
            gt.append(t)
        gz = gt[2]
        gz = gz.at[0].add(gu[2, 1, 0] * u_lo[1] + gu[2, 0, 0] * u_lo[0])
        gz = gz.at[1].add(gu[2, 0, 1] * u_lo[1])
        gz = gz.at[-1].add(gu[2, 3, -1] * u_hi[0] + gu[2, 4, -1] * u_hi[1])
        gz = gz.at[-2].add(gu[2, 4, -2] * u_hi[0])
        gt[2] = gz
        gout = jnp.stack(gt)

        uout = ku[0] * Ub
        for o, (axis, d) in enumerate(OFFSETS7):
            if o:
                uout = uout + ku[o] * shift(Ub, axis, d)
        for c in range(3):
            uout = (uout + da[c, 1] * Ab[c]
                    + da[c, 0] * shift(Ab[c], c, -1)
                    + da[c, 2] * shift(Ab[c], c, +1))
        uout = uout.at[0].add(ku[5, 0] * u_lo[1] + da[2, 0, 0] * ab_lo[2])
        uout = uout.at[-1].add(ku[6, -1] * u_hi[0] + da[2, 2, -1] * ab_hi[2])

        if self.n_y > 1:
            # y-face ghost adds (face coefficients zeroed at construction,
            # so the local stencil saw zeros there — pure adds)
            gout = gout.at[1, :, 0, :].add(gm[0, 0] * u_ym[:, 1, :]
                                           + gm[0, 1] * u_ym[:, 0, :])
            gout = gout.at[1, :, 1, :].add(gm[0, 2] * u_ym[:, 1, :])
            gout = gout.at[1, :, -1, :].add(gp[0, 0] * u_yp[:, 0, :]
                                            + gp[0, 1] * u_yp[:, 1, :])
            gout = gout.at[1, :, -2, :].add(gp[0, 2] * u_yp[:, 0, :])
            uout = uout.at[:, 0, :].add(km[0] * u_ym[:, 1, :] + dm[0] * ay_m)
            uout = uout.at[:, -1, :].add(kp[0] * u_yp[:, 0, :] + dp[0] * ay_p)

        yA = yA.at[:, :, y0:y1, x0:x1].add(gout)
        yU = jnp.zeros(U.shape, U.dtype).at[:, y0:y1, x0:x1].set(uout)
        if self.n_y > 1:
            yA = self._a_y_corr(yA, ka3f, ka4f, a_ym, a_yp)
        return yA, yU

    def _a_block(self, ka, A, a_lo, a_hi):
        """Shared 7-point A stencil on the local slab + ghost-plane terms."""
        yA = ka[0] * A
        for o, (axis, d) in enumerate(OFFSETS7):
            if o:
                yA = yA + ka[o] * shift(A, axis, d)
        yA = yA.at[:, 0].add(ka[5, 0] * a_lo)
        yA = yA.at[:, -1].add(ka[6, -1] * a_hi)
        return yA

    def _local_div(self, da, A, dm=None, dp=None):
        y0, y1, x0, x1 = self.box
        if self.n_y > 1:
            y0, y1 = 0, A.shape[2]
        up, dn = self._zperms()
        az_lo = jax.lax.ppermute(A[2, -1, y0:y1, x0:x1], "z", up)
        az_hi = jax.lax.ppermute(A[2, 0, y0:y1, x0:x1], "z", dn)
        if self.n_y > 1:
            yup, ydn = self._yperms()
            ay_m = jax.lax.ppermute(A[1, :, -1, x0:x1], "y", yup)
            ay_p = jax.lax.ppermute(A[1, :, 0, x0:x1], "y", ydn)
        Ab = A[:, :, y0:y1, x0:x1]
        yUb = jnp.zeros(Ab.shape[1:], A.dtype)
        for c in range(3):
            yUb = (yUb + da[c, 1] * Ab[c]
                   + da[c, 0] * shift(Ab[c], c, -1)
                   + da[c, 2] * shift(Ab[c], c, +1))
        yUb = yUb.at[0].add(da[2, 0, 0] * az_lo)
        yUb = yUb.at[-1].add(da[2, 2, -1] * az_hi)
        if self.n_y > 1:
            yUb = yUb.at[:, 0, :].add(dm[0] * ay_m)
            yUb = yUb.at[:, -1, :].add(dp[0] * ay_p)
        return jnp.zeros(A.shape[1:], A.dtype).at[:, y0:y1, x0:x1].set(yUb)

    # ------------------------------------------------------------------
    def diagonal_padded(self) -> State:
        """Operator diagonal in padded space (1 on padded / non-U cells) —
        for right-Jacobi under the shard tier.  (Face-coefficient surgery
        never touches the diagonal slots.)"""
        NZp, NYp, NXp = self.padded_zyx
        ka0 = self.ka_p[0].astype(self.dtype)   # state dtype, not coeff dtype
        dA = jnp.broadcast_to(ka0[None], (3, NZp, NYp, NXp))
        dA = jnp.where(dA == 0, jnp.ones((), self.dtype), dA)
        dU = jnp.ones((NZp, NYp, NXp), self.dtype)
        if self.box is not None:
            y0, y1, x0, x1 = self.box
            ku0 = self.ku_p[0].astype(self.dtype)
            dU = dU.at[:, y0:y1, x0:x1].set(
                jnp.where(ku0 == 0, jnp.ones((), self.dtype), ku0))
        return State(dA, dU)
