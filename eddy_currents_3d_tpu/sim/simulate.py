"""Time-domain simulation driver.

One jitted step function reproduces the reference's main loop body
(EC3D.f90:241-455): evaluate source / motion-velocity expressions at time T,
(re)locate moving source voxels, build the right-hand side (sources +
trapezoidal inertial history + U-row coupling terms of the old solution),
zero the conductor-surface rows, solve with warm-started restarted BiCGSTAB,
then form the post-solve inertial carry ``J = (2C/dt)·A_new - rhs`` that
doubles as the eddy-current output field (EC3D.f90:412-432).

The host driver walks the step/output schedule (derived with the exact
float accumulation ``T = T + dt`` of the reference loop, EC3D.f90:452-455)
and writes legacy-VTK outputs at the ``jump`` cadence.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..assembly.assemble import AssembledSystem, assemble_operator
from ..assembly.stencil import State
from ..models.model import Model
from ..solvers.bicgstab import bicgstab_wr
from .motion import FunctionMotion, MotionState, advance_function, motion_init

__all__ = ["Simulation", "SimState", "StepInfo"]


class SimState(NamedTuple):
    A: jax.Array          # (3,nz,ny,nx) vector potential (solution)
    U: jax.Array          # (nz,ny,nx) scalar potential (solution, dense-masked)
    carry: jax.Array      # (3,nz,ny,nx) inertial history / eddy field (Jaf)
    motion: MotionState
    # previous-step solution for the extrapolated warm start (None under
    # warm_start="previous", keeping the reference's exact iterate path)
    prev: Optional[object] = None


class StepInfo(NamedTuple):
    iterations: jax.Array
    relres: jax.Array
    converged: jax.Array
    # flat 0-based cells of each function's (possibly moved) source voxels,
    # in function order — consumed by the src VTK writer
    src_cells: tuple
    src_values: tuple


class _AsyncVtkWriter:
    """Overlapped VTK output: device→host readback + encode + file write
    run on one worker thread while the device computes subsequent steps
    (the reference's separated ``Tsavedata`` accounting intent,
    EC3D.f90:237; the synchronous path serialized ~half the e2e wall into
    io).  Bytes are identical to the synchronous path — the worker calls
    the same ``write_outputs`` on a non-donated device snapshot of the two
    fields it needs (the live state's buffers are donated into the next
    step, so the snapshot is a real device copy, ~µs for these sizes)."""

    _WORKERS = 2   # D2H fetch + native encode release the GIL; a small
    #                pool overlaps them across output points

    def __init__(self, sim):
        import queue
        import threading

        self._sim = sim
        # bounds in-flight packed snapshots (~state-size each; 16 is a few
        # tens of MB worst-case, small next to the solve working set)
        self._q: "queue.Queue" = queue.Queue(maxsize=16)
        self._err = None
        # ONE packed buffer per output: every device-to-host fetch pays a
        # fixed latency, so fetching A, carry and each per-function source
        # value separately would pay it ~6 times per output; packing
        # collapses them into one fetch.  Source cells ride in a second
        # int32 pack only when sources move (static cells are the same
        # device arrays every step — the host copy is cached after the
        # first output).
        self._shape = None

        def pack_f(A, carry, values):
            flat = [A.ravel(), carry.ravel()]
            flat += [jnp.reshape(v, (1,)).astype(A.dtype) for v in values]
            return jnp.concatenate(flat)

        self._pack_f = jax.jit(pack_f)
        self._pack_i = jax.jit(
            lambda cells: jnp.concatenate([jnp.asarray(c, jnp.int32).ravel()
                                           for c in cells]))
        self._moving = sim.flag_move
        # warm the pack compiles now (writer construction is setup, before
        # the timed loop) so the first output's submit doesn't charge a
        # jit compile to io time
        try:
            nz, ny, nx = sim.model.shape_zyx
            A0 = jax.ShapeDtypeStruct((3, nz, ny, nx), sim.dtype)
            v0 = tuple(jax.ShapeDtypeStruct((), sim.dtype)
                       for _ in sim.model.functions)
            self._pack_f.lower(A0, A0, v0).compile()
            if self._moving:
                c0 = tuple(jax.ShapeDtypeStruct((len(fn.cells),), jnp.int32)
                           for fn in sim.model.functions)
                self._pack_i.lower(c0).compile()
        except Exception:
            pass   # first submit compiles instead
        self._ts = [threading.Thread(target=self._loop, daemon=True)
                    for _ in range(self._WORKERS)]
        for t in self._ts:
            t.start()

    def _loop(self):
        from types import SimpleNamespace

        from ..io import vtk as vtkio

        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is None:
                    packed, cells, info, npoint, outdir = item
                    buf = np.asarray(packed)          # the one big fetch
                    shp = (3,) + self._shape
                    n = int(np.prod(shp))
                    st = SimpleNamespace(
                        A=buf[:n].reshape(shp),
                        carry=buf[n:2 * n].reshape(shp))
                    vals = buf[2 * n:]
                    if cells is not None:             # moving sources
                        ci = np.asarray(cells)
                        out_cells, off = [], 0
                        for c in info.src_cells:
                            m = int(c.shape[0])
                            out_cells.append(ci[off:off + m])
                            off += m
                    else:
                        out_cells = info.src_cells    # static: cached fetch
                    info2 = SimpleNamespace(src_cells=tuple(out_cells),
                                            src_values=tuple(vals))
                    vtkio.write_outputs(self._sim, st, info2, npoint, outdir)
            except BaseException as e:  # re-raised on submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, state, info, npoint: int, outdir: str) -> None:
        if self._err is not None:
            raise self._err
        if self._shape is None:
            self._shape = tuple(state.A.shape[1:])
        packed = self._pack_f(state.A, state.carry, tuple(info.src_values))
        cells = self._pack_i(tuple(info.src_cells)) if self._moving else None
        # the worker thread initiates the fetch, so this loop never waits
        # on the transfer
        self._q.put((packed, cells, info, npoint, outdir))

    def close(self) -> None:
        for _ in self._ts:
            self._q.put(None)
        for t in self._ts:
            t.join()
        if self._err is not None:
            raise self._err


def _schedule(tran):
    """Step times + output points with the reference's exact bookkeeping
    (EC3D.f90:137-143, 436-455)."""
    T, dt, Time, dtt = 0.0, float(tran.step), float(tran.stop), float(tran.jump)
    nout = int(np.round(dtt / dt)) if dt > 0 else 0
    nprint = nout
    ntime = 0
    steps = []  # (t, output_point_or_None)
    while True:
        out = None
        if ntime >= nprint and ntime != 0:
            nprint = ntime + nout
            out = sum(1 for _, o in steps if o is not None) + 1
        steps.append((T, out))
        ntime += 1
        T = T + dt
        if not (T < Time):
            break
    return steps


class Simulation:
    """End-to-end simulation of a :class:`Model` on the current backend."""

    def __init__(
        self,
        model: Model,
        dtype=jnp.float32,
        dot_dtype=None,
        mesh=None,
        system: Optional[AssembledSystem] = None,
        donate: bool = True,
        precond: Optional[str] = None,
        cheb_order: int = 4,
        cheb_ratio: float = 30.0,
        use_shard_map: Optional[bool] = None,
        coeff_dtype=None,
        warm_start: str = "extrapolate",
    ):
        self.model = model
        self.dtype = dtype
        self.dot_dtype = dot_dtype
        self.mesh = mesh
        self.system = system if system is not None else assemble_operator(model, dtype)
        if coeff_dtype is not None and coeff_dtype != self.system.op.dtype:
            # mixed precision: coefficient streams in coeff_dtype (bf16
            # halves the dominant HBM traffic of the matvec), state and
            # accumulation stay in `dtype` (bf16 x f32 promotes to f32) —
            # the solved operator is A rounded entrywise to coeff_dtype
            import dataclasses
            self.system = dataclasses.replace(
                self.system, op=self.system.op.astype(coeff_dtype))
        self.coeff_dtype = coeff_dtype

        # the operator is chosen from what the run can observe: float32
        # single-device runs with full-precision coefficients take the
        # case-coded operator (ops/coded.py: one code + one C field on the
        # conductor box instead of the 38 coefficient streams; about twice
        # as fast per step on the H100 at 256x256x64, PERF.md), whenever
        # its encoder proves it reproduces the assembly; everything else
        # applies the assembled coefficient fields.  Mesh runs use the
        # explicit shard_map tier below.
        from ..ops.coded import CodedUnsupported, from_assembled_coded
        self.coded_op = None
        if mesh is None and coeff_dtype is None and dtype == jnp.float32:
            try:
                self.coded_op = from_assembled_coded(self.system, model)
            except CodedUnsupported:
                pass

        # explicit multi-device tier: (z, y)-decomposed shard_map with halo
        # ppermute (parallel/shard_op.py).  The GSPMD flat-roll tier is
        # kept for the mg preconditioner, whose V-cycle is built on the
        # unsharded grid.
        if mesh is not None and use_shard_map is None:
            use_shard_map = precond != "mg"
        self.shard_op = None
        if mesh is not None and use_shard_map:
            from ..parallel.shard_op import ShardedStencilOperator
            self.shard_op = ShardedStencilOperator(
                self.system, mesh, dtype, coeff_dtype=coeff_dtype)

        if precond not in (None, "cheb", "jacobi", "cheb_jacobi", "mg", "ilu0"):
            raise ValueError(f"unknown preconditioner {precond!r}")
        self.precond = precond
        # warm start for the per-step solve.  The reference warm-starts from
        # the previous solution (Uaf is solved in place, EC3D.f90:408);
        # "extrapolate" starts from the linear prediction 2 x_{n-1} - x_{n-2}
        # instead — measured 1.43x fewer total iterations on the TEAM7
        # transient with the identical ||b - A x||/||b|| < tol stopping rule
        # (the converged answer is tolerance-equivalent; x0 never enters the
        # criterion).  "previous" reproduces the reference iterate path.
        if warm_start not in ("extrapolate", "previous"):
            raise ValueError(f"unknown warm_start {warm_start!r}")
        self.warm_start = warm_start
        if precond == "ilu0":
            # right-ILU(0) in stencil form (solvers/ilu0.py
            # ilu0_stencil_factorize): host factorization on the CSR
            # export, factors re-expressed as strict-triangular stencil
            # operators and applied as fixed Jacobi sweeps per triangle —
            # streaming applies, never gathers.
            if mesh is not None:
                raise ValueError("precond='ilu0' is single-device only")
            from ..solvers.ilu0 import ilu0_stencil_factorize
            self._ilu = ilu0_stencil_factorize(self.system, model, dtype=dtype)
            self.ilu_sweeps = 2
        if precond == "mg":
            # geometric V-cycle on the shared A-block stencil
            from ..solvers.multigrid import build_mg
            ka_mg = self.system.op.ka
            ku0 = np.zeros(ka_mg.shape[1:])
            if self.system.op.box is not None:
                z0, z1, y0, y1, x0, x1 = self.system.op.box
                ku0[z0:z1, y0:y1, x0:x1] = np.asarray(self.system.op.ku[0])
            self._mg = build_mg(ka_mg, ku0=ku0, dtype=dtype)
        if precond == "cheb_jacobi":
            # Gershgorin bound of the diagonally-scaled operator D^-1 A
            # (similar to A D^-1): max row sum of |a_ij| / d_i.  On the
            # scaled system the spectrum is normalized (~[eps, 2.x]) so
            # Chebyshev targets it far more tightly than on raw A, where the
            # conductor 2C/dt diagonal dwarfs the air Laplacian rows.
            ka = np.abs(self.system.np_ka).sum(0)   # full-grid (7,nz,ny,nx) sums
            rs_a = ka[None] + np.abs(self.system.np_gu).sum(1)   # (3,nz,ny,nx)
            diag_a = np.abs(self.system.np_ka[0])
            ratio_a = np.where(diag_a[None] > 0,
                               rs_a / np.maximum(diag_a[None], 1e-300), 0.0)
            ku0 = np.abs(self.system.np_ku[0])
            rs_u = (np.abs(self.system.np_ku).sum(0)
                    + np.abs(self.system.np_da).sum((0, 1)))
            ratio_u = np.where(ku0 > 0, rs_u / np.maximum(ku0, 1e-300), 0.0)
            self._scaled_lmax = float(max(ratio_a.max(), ratio_u.max())) * 1.01
        if precond in ("jacobi", "cheb_jacobi"):
            # right-Jacobi: solve (A D^-1) y = b, x = D^-1 y — the residual
            # history/convergence test stays that of the original system
            if self.shard_op is not None:
                d = self.shard_op.diagonal_padded()
            else:
                d = self.system.op.diagonal()
                d = State(d.A.astype(dtype), d.U.astype(dtype))
            self._jac_d = d
            self._jac_inv = State((1.0 / d.A).astype(dtype),
                                  (1.0 / d.U).astype(dtype))
        self.cheb_order = cheb_order
        self.cheb_ratio = cheb_ratio
        self.steps = _schedule(model.tran)
        self.n_steps = len(self.steps)

        nx, ny, nz = model.shape_xyz
        self._N = nx * ny * nz
        self.flag_move = any(any(f.move) for f in model.functions)

        # host-side static per-function data
        self._funs = []
        for idx, fn in enumerate(model.functions):
            cells = fn.cells.astype(np.int32)
            ijk0 = np.stack(
                [cells % nx, (cells // nx) % ny, cells // (nx * ny)], axis=1
            ).astype(np.int32)
            const_shift = np.array(
                [
                    fn.vmech_const[a] * model.tran.step / model.delta[a]
                    if (fn.vmech_index[a] == 0 and fn.move[a] != 0)
                    else 0.0
                    for a in range(3)
                ]
            )
            comp = {"X": 0, "Y": 1, "Z": 2}[fn.direction]
            self._funs.append(
                (
                    comp,
                    fn,
                    jnp.asarray(cells),
                    FunctionMotion(
                        index=idx,
                        ijk0=ijk0,
                        const_shift=const_shift,
                        vmech_index=fn.vmech_index,
                        shape_xyz=model.shape_xyz,
                    ),
                )
            )

        if mesh is not None:
            from ..parallel.mesh import shard_system, shard_state
            # when the explicit shard tier owns the per-device coefficient
            # layout, drop (never place) system.op's streams — one
            # coefficient copy per device, not two
            self.system = shard_system(self.system, mesh,
                                       include_op=self.shard_op is None)
            self._shard_state = lambda s: shard_state(s, mesh)
        else:
            self._shard_state = lambda s: s

        # Every device array the jitted step reads is passed as an explicit
        # argument pytree, never a closure capture: JAX inlines captured
        # arrays into the lowered module as dense literals, so a 4M-cell
        # operator closed over by the step would bloat the module and its
        # compile time (past the 2 GB executable limit at 256x256x64).
        self._params = {
            "cond": self.system.cond_mask,
            "inert": self.system.inert,
            "bnd_a": self.system.bnd_a,
            "bnd_u_any": self.system.bnd_u_any,
            "op": (self.shard_op if self.shard_op is not None
                   else self.coded_op if self.coded_op is not None
                   else self.system.op),
            "jac": ((self._jac_d, self._jac_inv)
                    if precond in ("jacobi", "cheb_jacobi") else None),
            "ilu": self._ilu if precond == "ilu0" else None,
            "mg": self._mg if precond == "mg" else None,
            "cells": tuple(cells for _, _, cells, _ in self._funs),
        }
        self._step_pjit = jax.jit(self._step_p,
                                  donate_argnums=(1,) if donate else ())
        self._step_jit = lambda state, t: self._step_pjit(self._params, state, t)
        self._scan_jit = {}   # built lazily by run_scan (keyed on output on/off)
        self._seg_jit = {}    # chunked-scan segments, keyed on length

    @property
    def operator(self):
        """The operator the solve applies (coded, field, or the shard tier)."""
        return self._params["op"]

    @property
    def operator_name(self) -> str:
        """Which operator path the solve takes: ``coded``, ``field``, or
        on a mesh ``shard_map-field`` / ``gspmd-field``."""
        if self.shard_op is not None:
            return "shard_map-field"
        if self.mesh is not None:
            return "gspmd-field"
        return "coded" if self.coded_op is not None else "field"

    # ------------------------------------------------------------------
    def init_state(self) -> SimState:
        nz, ny, nx = self.model.shape_zyx
        st = SimState(
            A=jnp.zeros((3, nz, ny, nx), self.dtype),
            U=jnp.zeros((nz, ny, nx), self.dtype),
            carry=jnp.zeros((3, nz, ny, nx), self.dtype),
            motion=motion_init(len(self.model.functions)),
            prev=(State(jnp.zeros((3, nz, ny, nx), self.dtype),
                        jnp.zeros((nz, ny, nx), self.dtype))
                  if self.warm_start == "extrapolate" else None),
        )
        return self._shard_state(st)

    # ------------------------------------------------------------------
    def _step(self, state: SimState, t) -> tuple[SimState, StepInfo]:
        """Convenience eager/traceable form of the step (tests, entry
        points); the jitted paths call :meth:`_step_p` with the params
        pytree as an explicit argument."""
        return self._step_p(self._params, state, t)

    def _step_p(self, params, state: SimState, t) -> tuple[SimState, StepInfo]:
        model = self.model
        op = params["op"]
        cond = params["cond"]
        inert = params["inert"]
        dt = float(model.tran.step)

        # motion-velocity functions at time t (EC3D.f90:260-271)
        if model.vmech:
            vmech_vals = jnp.stack([jnp.asarray(vm(t), jnp.result_type(t)) for vm in model.vmech])
        else:
            vmech_vals = jnp.zeros((0,))

        # ---- source scatter (EC3D.f90:275-367) ----
        base = jnp.where(cond[None], state.carry, 0.0).reshape(3, self._N)
        motion = state.motion
        src_cells = []
        src_values = []
        if self.flag_move:
            movestop = motion.movestop
            dist_rows = []
            comp_rows = []
            for (comp, fn, _, fm), cells in zip(self._funs, params["cells"]):
                drow, crow, movestop, flat = advance_function(
                    fm, motion.distance[fm.index], motion.comp[fm.index],
                    movestop, vmech_vals, dt, model.delta
                )
                dist_rows.append(drow)
                comp_rows.append(crow)
                val = jnp.asarray(fn(t), self.dtype)
                base = base.at[comp, flat].set(val)
                src_cells.append(flat)
                src_values.append(val)
            motion = MotionState(distance=jnp.stack(dist_rows),
                                 movestop=movestop,
                                 comp=jnp.stack(comp_rows))
        else:
            for (comp, fn, _, fm), cells in zip(self._funs, params["cells"]):
                val = jnp.asarray(fn(t), self.dtype)
                base = base.at[comp, cells].set(val)
                src_cells.append(cells)
                src_values.append(val)

        nzyx = self.model.shape_zyx
        rhs_A = base.reshape((3,) + nzyx) + inert[None] * state.A
        rhs_U = op.apply_div(state.A)
        rhs_A = jnp.where(params["bnd_a"], 0.0, rhs_A)
        rhs_U = jnp.where(params["bnd_u_any"], 0.0, rhs_U)

        # ---- solve (EC3D.f90:408) ----
        b = State(rhs_A, rhs_U)
        if self.warm_start == "extrapolate":
            # linear prediction from the last two solutions (see __init__)
            x0 = State(2.0 * state.A - state.prev.A,
                       2.0 * state.U - state.prev.U)
        else:
            x0 = State(state.A, state.U)
        tol = jnp.asarray(model.solver.tolerance, self.dtype)
        # the shard tier solves in its padded space (padded cells have zero
        # coefficients and stay zero through BiCGSTAB)
        apply_fn, bb, xx0 = op.apply, b, x0
        if self.shard_op is not None:
            bb, xx0 = op.pad_state(b), op.pad_state(x0)
        if self.precond == "cheb":
            from ..solvers.chebyshev import bicgstab_wr_cheb
            lmax = self.system.gershgorin * 1.01
            res = bicgstab_wr_cheb(
                apply_fn, bb, xx0, tol, model.solver.itmax,
                order=self.cheb_order, lmin=lmax / self.cheb_ratio, lmax=lmax,
                dot_dtype=self.dot_dtype,
            )
            sol_x = res.x
        elif self.precond in ("jacobi", "cheb_jacobi"):
            d, inv = params["jac"]
            mul = lambda a, v: State(a.A * v.A, a.U * v.U)
            scaled = lambda v: apply_fn(mul(inv, v))
            if self.precond == "cheb_jacobi":
                from ..solvers.chebyshev import bicgstab_wr_cheb
                lmax = self._scaled_lmax
                res = bicgstab_wr_cheb(
                    scaled, bb, mul(d, xx0), tol, model.solver.itmax,
                    order=self.cheb_order, lmin=lmax / self.cheb_ratio,
                    lmax=lmax, dot_dtype=self.dot_dtype,
                )
            else:
                res = bicgstab_wr(
                    scaled, bb, mul(d, xx0),
                    tol, model.solver.itmax, dot_dtype=self.dot_dtype,
                )
            sol_x = mul(inv, res.x)
        elif self.precond == "mg":
            from ..solvers.bicgstab import bicgstab_wr_right
            res = bicgstab_wr_right(
                apply_fn, params["mg"].apply, bb, xx0, tol, model.solver.itmax,
                dot_dtype=self.dot_dtype,
            )
            sol_x = res.x
        elif self.precond == "ilu0":
            from ..solvers.bicgstab import bicgstab_wr_right

            ilu = params["ilu"]
            minv = lambda v: ilu.apply(v, sweeps=self.ilu_sweeps)

            res = bicgstab_wr_right(
                apply_fn, minv, bb, xx0, tol, model.solver.itmax,
                dot_dtype=self.dot_dtype,
            )
            sol_x = res.x
        else:
            res = bicgstab_wr(
                apply_fn, bb, xx0, tol, model.solver.itmax,
                dot_dtype=self.dot_dtype,
            )
            sol_x = res.x
        sol = op.unpad_state(sol_x) if self.shard_op is not None else sol_x
        A_new, U_new = sol.A, sol.U

        # ---- post-solve inertial carry + surface zeroing (EC3D.f90:412-432)
        carry = jnp.where(cond[None], inert[None] * A_new - rhs_A, rhs_A)
        carry = jnp.where(params["bnd_a"], 0.0, carry)
        A_out = jnp.where(params["bnd_a"], 0.0, A_new)

        new_state = SimState(
            A=A_out, U=U_new, carry=carry, motion=motion,
            prev=(State(state.A, state.U)
                  if self.warm_start == "extrapolate" else None),
        )
        info = StepInfo(
            iterations=res.iterations,
            relres=res.relres,
            converged=res.converged,
            src_cells=tuple(src_cells),
            src_values=tuple(src_values),
        )
        return new_state, info

    # ------------------------------------------------------------------
    def run_scan(self, num_steps: Optional[int] = None,
                 initial_state: Optional[SimState] = None,
                 output_dir: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 resume: bool = False):
        """Run ``num_steps`` timesteps entirely on device as one
        ``lax.scan`` dispatch (no host round-trip per step).

        This is the maximum-throughput path: the host-loop :meth:`run` pays
        one dispatch+sync per step, while the reference pays its per-step
        host work inline (EC3D.f90:241-455).

        With ``output_dir``, field_N.vtk / src_N.vtk stream out at the jump
        cadence (EC3D.f90:436-444) through an unordered ``io_callback``
        fired only on output steps — files are identical to :meth:`run`'s,
        and the device never waits on a per-step host round-trip.

        ``checkpoint_dir`` + ``checkpoint_every`` enable checkpointing
        (same files as :meth:`run`); checkpoint runs always take the
        chunked path, segmented additionally at checkpoint boundaries, so a
        resumed run replays the identical per-step computation.

        Returns (final_state, stacked diagnostics).
        """
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        steps = self.steps if num_steps is None else self.steps[:num_steps]
        times = jnp.asarray([t for t, _ in steps],
                            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        start = 0
        state = initial_state
        fingerprint = None
        if checkpoint_dir is not None:
            from . import checkpoint as ckpt
            fingerprint = ckpt.model_fingerprint(self.model)
            if resume:
                loaded, start = self._load_resume(checkpoint_dir, fingerprint)
                if loaded is not None:   # no checkpoint yet: keep
                    state = loaded       # initial_state (or cold start)
        if state is None:
            state = self.init_state()

        if checkpoint_dir is not None:
            return self._run_scan_chunked(
                steps, times, state, output_dir,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                fingerprint=fingerprint, start=start)

        key = output_dir is not None
        if self._scan_jit.get(key) is None:
            if output_dir is None:
                def body(params, st, inp):
                    new_st, info = self._step_p(params, st, inp[0])
                    return new_st, (info.iterations, info.relres, info.converged)
            else:
                from types import SimpleNamespace
                from jax.experimental import io_callback
                from ..io import vtk as vtkio

                n_fun = len(self.model.functions)

                def emit(npoint, A, carry, *cells_vals):
                    st_like = SimpleNamespace(A=A, carry=carry)
                    info_like = SimpleNamespace(
                        src_cells=cells_vals[:n_fun],
                        src_values=cells_vals[n_fun:])
                    vtkio.write_outputs(self, st_like, info_like,
                                        int(npoint), self._scan_outdir)

                def body(params, st, inp):
                    t, npoint = inp
                    new_st, info = self._step_p(params, st, t)
                    args = (npoint, new_st.A, new_st.carry,
                            *info.src_cells, *info.src_values)
                    jax.lax.cond(
                        npoint > 0,
                        lambda *a: io_callback(emit, None, *a, ordered=False),
                        lambda *a: None,
                        *args)
                    return new_st, (info.iterations, info.relres, info.converged)

            # params enters the jitted scan as an argument; the scan
            # body closes over its *tracer*, which lowers as shared values
            # rather than inlined literals (see __init__)
            self._scan_jit[key] = jax.jit(
                lambda params, st, ts, outs: jax.lax.scan(
                    lambda c, inp: body(params, c, inp), st, (ts, outs)))

        if output_dir is not None:
            import os
            self._scan_outdir = output_dir
            os.makedirs(output_dir, exist_ok=True)
        out_points = jnp.asarray([o if o is not None else 0 for _, o in steps],
                                 jnp.int32)
        final, (iters, relres, conv) = self._scan_jit[key](
            self._params, state, times, out_points)
        if output_dir is not None:
            jax.effects_barrier()   # all streamed writes landed
        return final, {"iterations": iters, "relres": relres,
                       "converged": conv}

    def _load_resume(self, checkpoint_dir, fingerprint):
        """Shared resume: newest checkpoint -> (state, start_index), with
        warm-start-history normalization to this run's mode."""
        from . import checkpoint as ckpt
        path = ckpt.latest_checkpoint(checkpoint_dir)
        if path is None:
            return None, 0
        state, start, _ = ckpt.load_checkpoint(path, fingerprint, self.dtype)
        # a pre-extrapolation checkpoint seeds prev = x (the first resumed
        # step starts from the previous solution, then extrapolation takes
        # over); "previous" mode drops any stored history
        if self.warm_start == "extrapolate" and state.prev is None:
            state = state._replace(prev=State(state.A, state.U))
        if self.warm_start == "previous" and state.prev is not None:
            state = state._replace(prev=None)
        return self._shard_state(state), start

    def _run_scan_chunked(self, steps, times, state, output_dir,
                          checkpoint_dir=None, checkpoint_every=0,
                          fingerprint=None, start=0):
        """Checkpointed scan: each segment between checkpoint or output
        points is one on-device lax.scan dispatch; each output step runs
        through the host-visible step so write_outputs sees its source
        cells, and the state is host-visible at checkpoint boundaries, so
        ckpt_<step>.npz files match :meth:`run`'s."""
        import os
        from . import checkpoint as ckpt

        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
        every = checkpoint_every if (checkpoint_dir and checkpoint_every) else 0

        def seg(n):
            if n not in self._seg_jit:
                def body(params, st, t):
                    new_st, info = self._step_p(params, st, t)
                    return new_st, (info.iterations, info.relres, info.converged)
                self._seg_jit[n] = jax.jit(
                    lambda params, st, ts: jax.lax.scan(
                        lambda c, tt: body(params, c, tt), st, ts))
            return lambda st, ts: self._seg_jit[n](self._params, st, ts)

        iters, relres, conv = [], [], []
        i = start
        t_io = 0.0
        last_ck = None

        def flush_to(j):
            nonlocal i, state
            if j > i:
                state, (it, rr, cv) = seg(j - i)(state, times[i:j])
                iters.append(it), relres.append(rr), conv.append(cv)
                i = j

        writer = _AsyncVtkWriter(self) if output_dir is not None else None
        try:
            for j in range(start, len(steps)):
                t, out = steps[j]
                is_out = out is not None and output_dir is not None
                is_ck = every and (j + 1) % every == 0
                if is_out:
                    flush_to(j)
                    state, info = self._step_jit(state, times[j])
                    # async write: the next segment's scan dispatch below
                    # overlaps the readback+encode on the worker thread
                    t1 = _time.perf_counter()
                    writer.submit(state, info, out, output_dir)
                    t_io += _time.perf_counter() - t1
                    iters.append(info.iterations[None])
                    relres.append(info.relres[None])
                    conv.append(info.converged[None])
                    i = j + 1
                elif is_ck:
                    flush_to(j + 1)
                if is_ck:
                    t1 = _time.perf_counter()
                    ckpt.save_checkpoint(
                        os.path.join(checkpoint_dir, f"ckpt_{j + 1}.npz"),
                        state, j + 1, out or 0, fingerprint)
                    last_ck = j + 1
                    t_io += _time.perf_counter() - t1
            flush_to(len(steps))
        finally:
            if writer is not None:
                t1 = _time.perf_counter()
                writer.close()
                t_io += _time.perf_counter() - t1
        # final checkpoint only when steps actually ran this call (an
        # empty horizon, or resuming past num_steps, must neither crash on
        # steps[-1] nor write a checkpoint whose step index contradicts
        # the state it contains) and the loop didn't just write the
        # identical ckpt_<len>.npz itself
        if checkpoint_dir is not None and every and start < len(steps) \
                and last_ck != len(steps):
            ckpt.save_checkpoint(
                os.path.join(checkpoint_dir, f"ckpt_{len(steps)}.npz"),
                state, len(steps), steps[-1][1] or 0, fingerprint)
        def cat(xs, dtype):
            # resuming at/after the last step leaves nothing to run
            if not xs:
                return jnp.zeros((0,), dtype)
            return jnp.concatenate([jnp.atleast_1d(x) for x in xs])
        return state, {"iterations": cat(iters, jnp.int32),
                       # empty-horizon dtype must match a live run's (the
                       # solver computes relres in the field dtype)
                       "relres": cat(relres, self.dtype),
                       "converged": cat(conv, jnp.bool_),
                       "start_step": start,
                       "io_s": t_io}

    # ------------------------------------------------------------------
    def run(
        self,
        num_steps: Optional[int] = None,
        output_dir: Optional[str] = None,
        on_output: Optional[Callable] = None,
        progress: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        initial_state: Optional[SimState] = None,
    ):
        """Run the transient.

        * ``output_dir``: write field_N.vtk / src_N.vtk at the jump cadence.
        * ``on_output(npoint, state, info)``: callback at each output point.
        * ``checkpoint_dir`` + ``checkpoint_every``: save ckpt_<step>.npz
          every N steps; ``resume=True`` continues from the newest one
          (validated against a model fingerprint).
        * ``progress``: the reference's 1%% ``>`` ticker (EC3D.f90:446-450).

        Returns (final_state, diagnostics dict with per-step iteration
        counts, solve/io wall-time split, and the unconverged-step count).
        """
        import os
        from . import checkpoint as ckpt

        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        start = 0
        state = initial_state
        fingerprint = None
        if checkpoint_dir is not None:
            fingerprint = ckpt.model_fingerprint(self.model)
            if resume:
                loaded, start = self._load_resume(checkpoint_dir, fingerprint)
                if loaded is not None:   # no checkpoint yet: keep
                    state = loaded       # initial_state (or cold start)
        if state is None:
            state = self.init_state()

        steps = self.steps if num_steps is None else self.steps[:num_steps]
        infos = []
        writer = _AsyncVtkWriter(self) if output_dir is not None else None
        t0 = _time.perf_counter()
        t_io = 0.0
        last_ck = None
        tick = max(len(self.steps) // 100, 1)
        try:
            for idx in range(start, len(steps)):
                t, out = steps[idx]
                state, info = self._step_jit(state, t)
                infos.append(info)
                if out is not None:
                    t1 = _time.perf_counter()
                    if writer is not None:
                        # async: readback+encode+write overlap the next
                        # steps' device compute (t_io counts only the time
                        # this loop stayed blocked on io)
                        writer.submit(state, info, out, output_dir)
                    if on_output is not None:
                        on_output(out, state, info)
                    t_io += _time.perf_counter() - t1
                if checkpoint_dir is not None and checkpoint_every and (idx + 1) % checkpoint_every == 0:
                    t1 = _time.perf_counter()
                    ckpt.save_checkpoint(
                        os.path.join(checkpoint_dir, f"ckpt_{idx + 1}.npz"),
                        state, idx + 1, out or 0, fingerprint,
                    )
                    last_ck = idx + 1
                    t_io += _time.perf_counter() - t1
                if progress and idx % tick == 0:
                    print(">", end="", flush=True)
            jax.block_until_ready(state)
        finally:
            if writer is not None:
                t1 = _time.perf_counter()
                writer.close()       # drain pending writes
                t_io += _time.perf_counter() - t1
        wall = _time.perf_counter() - t0
        # final checkpoint only when steps actually ran this call (see
        # _run_scan_chunked: no crash on an empty horizon, no checkpoint
        # whose step index contradicts its state) and the loop didn't
        # just write the identical ckpt_<len>.npz itself
        if checkpoint_dir is not None and checkpoint_every \
                and start < len(steps) and last_ck != len(steps):
            ckpt.save_checkpoint(
                os.path.join(checkpoint_dir, f"ckpt_{len(steps)}.npz"),
                state, len(steps), steps[-1][1] or 0, fingerprint,
            )

        iters = [int(i.iterations) for i in infos]
        unconverged = [start + i for i, inf in enumerate(infos) if not bool(inf.converged)]
        if unconverged:
            # the reference prints the residual norm on itmax overflow and
            # carries on (solvers.f90:25-27)
            print(f"WARNING: solver hit itmax without converging at "
                  f"{len(unconverged)} step(s), first at step {unconverged[0]}")
        return state, {
            "wall_s": wall,
            "io_s": t_io,
            "steps": len(steps) - start,
            "start_step": start,
            "iterations": iters,
            "total_iterations": int(np.sum(iters)) if iters else 0,
            "unconverged_steps": unconverged,
        }
