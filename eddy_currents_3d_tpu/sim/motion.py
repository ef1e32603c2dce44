"""Moving-source subsystem, expressed functionally for `jit`.

Reproduces the reference's motion semantics (EC3D.f90:156-230, 1052-1114)
as pure functions of a small carried state:

* per-function accumulated ``Distance(3)`` (fractions of a cell) and the
  *global* 3-vector ``movestop`` latch shared by every function;
* constant-velocity axes accumulate ``movestop(1) * shift`` — the reference
  multiplies by the X-axis latch regardless of axis (EC3D.f90:1055), kept
  for parity — while function-driven axes accumulate ``V(t)*dt/delta``
  ignoring the latch (EC3D.f90:1058);
* integer displacement ``length = nint(Distance)``;
* each source voxel is displaced by ``length`` and clamped per-axis to
  ``[2, sd-2]`` (1-based); a clamp drops the axis latch to 0, and any
  in-range voxel re-arms it (EC3D.f90:1068-1111).

The per-voxel latch update is a sequential fold in the reference, but each
voxel's transition is either "set 0" (clamped), "set 1" (in range, re-arm
condition true) or "no-op", so the fold collapses to "value written by the
last non-no-op voxel" — computed vectorized here, bit-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MotionState", "motion_init", "advance_function"]


class MotionState(NamedTuple):
    distance: jax.Array    # (numfun, 3) accumulated displacement
    movestop: jax.Array    # (3,) int32 global latch (EC3D.f90:238)
    # Kahan compensation for `distance`: the reference accumulates Distance
    # in float64 (EC3D.f90:1052-1062); without x64 the state is f32,
    # where a plain running sum drifts by ~n*ulp over n steps and can
    # mis-round the nint() voxel shift on long transients.  Compensated
    # summation bounds the error to ~1 ulp of each term independent of
    # step count, matching f64 accumulation for any realistic trajectory.
    comp: jax.Array        # (numfun, 3) same dtype as distance


def motion_init(numfun: int, dtype=None) -> MotionState:
    if dtype is None:
        dtype = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return MotionState(
        distance=jnp.zeros((numfun, 3), dtype),
        movestop=jnp.ones((3,), jnp.int32),
        comp=jnp.zeros((numfun, 3), dtype),
    )


def _anint(x):
    # Fortran NINT: round half away from zero.
    return jnp.trunc(x + jnp.where(x >= 0, 0.5, -0.5)).astype(jnp.int32)


@dataclass(frozen=True)
class FunctionMotion:
    """Static (host-side) motion description of one source function."""

    index: int                      # position in model.functions
    ijk0: np.ndarray                # (numnod, 3) 0-based original (i,j,k)
    const_shift: np.ndarray         # (3,) shift per step for constant-velocity axes
    vmech_index: tuple[int, int, int]   # 1-based into the Vmech value vector
    shape_xyz: tuple[int, int, int]


def advance_function(
    fm: FunctionMotion,
    distance_row: jax.Array,        # (3,)
    comp_row: jax.Array,            # (3,) Kahan compensation
    movestop: jax.Array,            # (3,) int32
    vmech_vals: jax.Array,          # (numMech,) velocities at this step
    dt: float,
    delta: np.ndarray,
):
    """One function's motion for one step.

    Returns (new_distance_row, new_comp_row, new_movestop, new_flat_cells)
    where new_flat_cells are 0-based flat grid indices of the displaced
    voxels.
    """
    # --- motion_calc (EC3D.f90:1052-1062), Kahan-compensated so the f32
    # running sum tracks the reference's f64 accumulator (see MotionState)
    parts, comps = [], []
    for a in range(3):
        vi = fm.vmech_index[a]
        if vi == 0:
            # constant velocity: gated by the X latch (reference quirk).
            # While latched off, the reference's Distance += 0*shift
            # freezes the accumulator bit-exactly — so the Kahan update
            # (which would fold the pending compensation into distance
            # even for a zero term) is skipped entirely, not fed zero.
            gate = movestop[0] > 0
            term = jnp.asarray(fm.const_shift[a], distance_row.dtype)
        else:
            # function-driven axes accumulate every step (latch ignored,
            # EC3D.f90:1057-1059)
            gate = None
            term = (vmech_vals[vi - 1] * (dt / float(delta[a]))
                    ).astype(distance_row.dtype)
        y = term - comp_row[a]
        t = distance_row[a] + y
        c = (t - distance_row[a]) - y
        if gate is not None:
            t = jnp.where(gate, t, distance_row[a])
            c = jnp.where(gate, c, comp_row[a])
        parts.append(t)
        comps.append(c)
    new_dist = jnp.stack(parts)
    new_comp = jnp.stack(comps)
    length = _anint(new_dist)       # (3,)

    # --- new_m (EC3D.f90:1064-1114), vectorized over voxels ---
    sd = np.asarray(fm.shape_xyz)
    lo = 1                           # 0-based lower clamp (= 2 in 1-based)
    new_ms = []
    pos = []
    for a in range(3):
        hi = int(sd[a]) - 3          # 0-based upper clamp (= sd-2 in 1-based)
        raw = fm.ijk0[:, a] + length[a]
        clamped_hi = raw > hi
        clamped_lo = raw < lo
        clamped = clamped_hi | clamped_lo
        newv = jnp.clip(raw, lo, hi)
        # re-arm condition uses the in-range value (EC3D.f90:1072)
        rearm = (~clamped) & ((newv < hi) | (newv > lo))
        nonid = clamped | rearm
        # value written by the last non-no-op voxel (0 on clamp, 1 on rearm)
        n = raw.shape[0]
        last_rel = jnp.argmax(nonid[::-1])           # 0 if none
        last_idx = n - 1 - last_rel
        any_nonid = jnp.any(nonid)
        written = jnp.where(clamped[last_idx], 0, 1).astype(jnp.int32)
        new_ms.append(jnp.where(any_nonid, written, movestop[a]))
        pos.append(newv)
    new_movestop = jnp.stack(new_ms)
    nx, ny = int(sd[0]), int(sd[1])
    flat = pos[0] + nx * pos[1] + nx * ny * pos[2]
    return new_dist, new_comp, new_movestop, flat
