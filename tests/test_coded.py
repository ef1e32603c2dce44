"""Case-coded operator (ops/coded.py): the encoder must prove itself
against the assembled fields (bit-exact f64 reconstruction), and the coded
apply must reproduce the field operator's matvec to f32-ulp accuracy on
every case family — including moving-conductor convection
(case_convection), moving coils, non-default BND multipliers, and the
inertia_on_faces extension."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from eddy_currents_3d_tpu.assembly.assemble import assemble_operator
from eddy_currents_3d_tpu.assembly.stencil import State
from eddy_currents_3d_tpu.ops.coded import (
    CodedUnsupported, from_assembled_coded,
)
from eddy_currents_3d_tpu.testing.cases import (
    case_convection, case_lim, case_moving, case_static, load_case,
)


def _rand_state(model, sysm, rng, dtype=jnp.float32):
    nz, ny, nx = model.shape_zyx
    A = rng.standard_normal((3, nz, ny, nx))
    U = rng.standard_normal((nz, ny, nx)) * np.asarray(sysm.cond_mask)
    return State(jnp.asarray(A, dtype), jnp.asarray(U, dtype))


def _check_case(model, rng, inertia_on_faces=False, atol_scale=3e-6):
    sysm = assemble_operator(model, jnp.float32,
                             inertia_on_faces=inertia_on_faces)
    # f64 ground truth for the comparison scale
    sys64 = assemble_operator(model, jnp.float64,
                              inertia_on_faces=inertia_on_faces)
    coded = from_assembled_coded(sysm, model,
                                 inertia_on_faces=inertia_on_faces)
    st = _rand_state(model, sysm, rng)
    y_ref = jax.jit(sys64.op.apply)(
        State(st.A.astype(jnp.float64), st.U.astype(jnp.float64)))
    y_cod = jax.jit(coded.apply)(st)
    scale = np.abs(np.asarray(y_ref.A)).max()
    np.testing.assert_allclose(np.asarray(y_cod.A, np.float64),
                               np.asarray(y_ref.A), atol=atol_scale * scale)
    uscale = max(np.abs(np.asarray(y_ref.U)).max(), scale)
    np.testing.assert_allclose(np.asarray(y_cod.U, np.float64),
                               np.asarray(y_ref.U), atol=atol_scale * uscale)
    return coded


def test_static_case(rng):
    model = load_case(case_static(shape_xyz=(18, 16, 14), steps=2))
    coded = _check_case(model, rng)
    assert not coded.has_conv


def test_lim_case(rng):
    # lim's coils move, but the conductor itself is static: has_conv must
    # be False (conductor velocity, not coil motion, drives convection)
    model = load_case(case_lim(shape_xyz=(24, 11, 10), steps=2))
    coded = _check_case(model, rng)
    assert not coded.has_conv


def test_moving_case(rng):
    model = load_case(case_moving(shape_xyz=(16, 16, 10), steps=2))
    coded = _check_case(model, rng)
    assert not coded.has_conv


def test_convection_case(rng):
    """Moving conductor (VEX/VEY/VEZ != 0): the has_conv kernel branch is
    live and the coded matvec must match the f64 field operator on EVERY
    component — the assembled convection pair ±Ve_a/(2Δ_a) sits in the
    shared A stencil (assemble.py:184-186), so each component row takes
    convection terms along all three axes, not just its own."""
    model = load_case(case_convection(shape_xyz=(24, 12, 10), steps=2))
    coded = _check_case(model, rng)
    assert coded.has_conv


def test_convection_single_axis(rng):
    # exercise the sparser conv pattern (only one axis live)
    model = load_case(case_convection(shape_xyz=(20, 12, 10), steps=2,
                                      ve=(0.0, 4.0, 0.0)))
    coded = _check_case(model, rng)
    assert coded.has_conv


@pytest.mark.parametrize("shape_xyz", [(11, 9, 7), (12, 19, 13)])
def test_odd_grid_sizes(rng, shape_xyz):
    """Odd extents and a plate against nothing but its 2-cell halo: the
    box slicing and zero-filled shifts carry no alignment assumption."""
    model = load_case(case_static(shape_xyz=shape_xyz, steps=2))
    _check_case(model, rng)


@pytest.mark.parametrize("ve", [(0.0, 0.0, 5.0), (-2.0, 0.0, 1.5)])
def test_convection_other_axes(rng, ve):
    """Convection along z alone and with mixed signs."""
    model = load_case(case_convection(shape_xyz=(20, 12, 10), steps=2, ve=ve))
    coded = _check_case(model, rng)
    assert coded.has_conv


def test_scale256_class_accepted():
    """from_assembled_coded accepts the 256³-class plane sizes, storing
    only the conductor box (construction only)."""
    model = load_case(case_static(shape_xyz=(256, 256, 8), steps=2))
    sysm = assemble_operator(model, jnp.float32)
    coded = from_assembled_coded(sysm, model)
    z0, z1, y0, y1, x0, x1 = coded.box
    assert coded.code.shape == (z1 - z0, y1 - y0, x1 - x0)
    assert coded.code.dtype == jnp.int32 and coded.cf.dtype == jnp.float32


def test_apply_is_one_state_pass(rng):
    """The coded apply carries no coefficient field beyond the box code
    and C: its operator arrays are a small fraction of the field
    operator's."""
    model = load_case(case_static(shape_xyz=(30, 28, 16), steps=2))
    sysm = assemble_operator(model, jnp.float32)
    coded = from_assembled_coded(sysm, model)
    nbytes = lambda op: sum(a.nbytes for a in jax.tree.leaves(op))
    assert nbytes(coded) * 10 < nbytes(sysm.op)


def test_custom_bnd_multipliers(rng):
    model = load_case(case_static(shape_xyz=(16, 14, 12), steps=2))
    model.solver.BND = np.array([[-1.0, -0.5], [0.25, -0.95],
                                 [0.0, -0.7]])
    _check_case(model, rng)


def test_inertia_on_faces(rng):
    model = load_case(case_static(shape_xyz=(16, 14, 12), steps=2))
    _check_case(model, rng, inertia_on_faces=True)


def test_apply_div_matches(rng):
    model = load_case(case_static(shape_xyz=(18, 16, 14), steps=2))
    sysm = assemble_operator(model, jnp.float32)
    sys64 = assemble_operator(model, jnp.float64)
    coded = from_assembled_coded(sysm, model)
    st = _rand_state(model, sysm, rng)
    d_ref = jax.jit(sys64.op.apply_div)(st.A.astype(jnp.float64))
    d_cod = jax.jit(coded.apply_div)(st.A)
    scale = max(np.abs(np.asarray(d_ref)).max(), 1.0)
    np.testing.assert_allclose(np.asarray(d_cod, np.float64),
                               np.asarray(d_ref), atol=3e-6 * scale)


def test_f64_unsupported():
    """float64 runs keep the field operator (the coded operator is chosen
    for float32 single-device runs only)."""
    from eddy_currents_3d_tpu.sim.simulate import Simulation

    model = load_case(case_static(shape_xyz=(14, 12, 10), steps=2))
    sim = Simulation(model, dtype=jnp.float64)
    assert sim.coded_op is None and sim.operator_name == "field"
    assert Simulation(model, dtype=jnp.float32).operator_name == "coded"


def test_proof_rejects_tampered_fields():
    """The encoder must refuse a system whose coefficients it cannot
    reproduce (defensive fallback path)."""
    model = load_case(case_static(shape_xyz=(14, 12, 10), steps=2))
    sysm = assemble_operator(model, jnp.float32)
    sysm.np_ku[0][sysm.np_ku[0] != 0] *= 1.5
    with pytest.raises(CodedUnsupported):
        from_assembled_coded(sysm, model)


def test_simulation_with_coded_operator_matches():
    """Full float32 transient on the coded operator (chosen automatically)
    vs the float64 field-operator run: tolerance-scale field agreement,
    convergence everywhere."""
    from eddy_currents_3d_tpu.sim.simulate import Simulation

    model = load_case(case_static(shape_xyz=(16, 14, 12), steps=3))
    ref, rdiag = Simulation(model, dtype=jnp.float64).run()
    assert not rdiag["unconverged_steps"]
    sim = Simulation(model, dtype=jnp.float32)
    assert sim.coded_op is not None
    st, diag = sim.run()
    assert not diag["unconverged_steps"]
    tol = model.solver.tolerance
    scale = np.abs(np.asarray(ref.A)).max()
    np.testing.assert_allclose(np.asarray(st.A), np.asarray(ref.A),
                               atol=4 * tol * scale)


def test_use_coded_incompatible_raises():
    """The operator follows from what the run can observe: a mesh or
    bf16 coefficient storage keeps the field operator, and a model the
    encoder cannot prove keeps it silently."""
    from eddy_currents_3d_tpu.parallel.mesh import make_mesh
    from eddy_currents_3d_tpu.sim.simulate import Simulation

    model = load_case(case_static(shape_xyz=(16, 14, 12), steps=2))
    assert Simulation(model, dtype=jnp.float32,
                      coeff_dtype=jnp.bfloat16).coded_op is None
    sim = Simulation(model, dtype=jnp.float32, mesh=make_mesh(2, 1))
    assert sim.coded_op is None and sim.shard_op is not None
    sysm = assemble_operator(model, jnp.float32)
    sysm.np_ku[0][sysm.np_ku[0] != 0] *= 1.5
    assert Simulation(model, dtype=jnp.float32, system=sysm).coded_op is None


def test_conductor_touching_z_face(rng):
    """Conductor slab starting at the z=0 grid face: exercises the gating
    lower bound zb0=0, the face-cell (non-intc) code bits, and clamped
    z-neighbor blocks at the grid edge."""
    from eddy_currents_3d_tpu.testing.cases import make_vxc_text

    nx, ny, nz = 20, 14, 12
    geo = np.zeros((nz, ny, nx), np.int64)
    geo[0:5, 3:ny - 3, 3:nx - 3] = 1          # slab ON the z- face
    geo[8, 4, 5:nx - 5] = 2                   # one x-directed coil run
    names = [
        "plast D=1 C='mu0*35e6'",
        "coil D=1 SRCx=F",
        "param tran stop=0.002 step=1e-3",
        "p2 solver tol=5e-3 itmax=10000 dir=out",
        "f1 func F=a*cos(p2*f*t) a='100/(dx*dz)' p2='2*pi' f=50 t=t",
    ]
    model = load_case(make_vxc_text((nx, ny, nz), 0.004, names, geo.ravel()))
    coded = _check_case(model, rng)
    assert coded.box[0] == 0
