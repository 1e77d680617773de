"""Cut-cell sharp-interface pressure (cutcell.py + build_poisson_op_cut):
geometry invariants, exact reduction to the staircase operator on aligned
bodies, operator symmetry, and projection exactness with both velocity and
pressure sharp. (The Cd convergence oracle lives in test_oracles.py.)"""

import jax.numpy as jnp
import numpy as np

from navierstokessolver_tpu import cutcell
from navierstokessolver_tpu.bcs import no_slip_box
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops.poisson import (
    PoissonConfig,
    apply_A,
    build_poisson_op,
    build_poisson_op_cut,
    solve_poisson,
)


def _disk_sdf(cx, cy, r):
    return lambda x, y: np.hypot(x - cx, y - cy) - r


def test_cut_geometry_invariants():
    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    ap, fluid, solid = cutcell.cut_geometry(g, _disk_sdf(0.5, 0.5, 0.2))
    for a in range(2):
        al = np.asarray(ap[a])
        assert al.shape == g.face_shape(a)
        assert (al >= 0).all() and (al <= 1).all()
        # partially-open faces exist (the point of the machinery)
        assert ((al > 0) & (al < 1)).any()
    assert solid.sum() > 0 and fluid.sum() > 0
    # faces of solid cells are fully closed
    for a in range(2):
        al = np.asarray(ap[a])
        lo = [slice(None)] * 2
        lo[a] = slice(0, -1)
        hi = [slice(None)] * 2
        hi[a] = slice(1, None)
        assert (al[tuple(lo)][solid] == 0).all()
        assert (al[tuple(hi)][solid] == 0).all()


def test_cut_reduces_to_staircase_on_aligned_box():
    """A grid-aligned rectangular body has all-0/1 apertures: the cut
    operator must equal the staircase operator exactly."""
    g = GridSpec(shape=(32, 16), lengths=(2.0, 1.0))
    bcs = no_slip_box(g)
    h = g.spacing
    # box spanning cells [8,16) x [4,8) exactly (faces on grid lines)
    x0, x1 = 8 * h[0], 16 * h[0]
    y0, y1 = 4 * h[1], 8 * h[1]

    def sdf(x, y):
        dx = np.maximum(x0 - x, x - x1)
        dy = np.maximum(y0 - y, y - y1)
        return np.maximum(dx, dy)  # negative strictly inside

    ap, fluid, solid = cutcell.cut_geometry(g, sdf)
    for a in range(2):
        al = np.asarray(ap[a])
        assert np.logical_or(al == 0.0, al == 1.0).all()
    op_cut = build_poisson_op_cut(g, bcs, ap, fluid)
    op_ref = build_poisson_op(g, bcs, solid)
    np.testing.assert_array_equal(np.asarray(op_cut.code),
                                  np.asarray(op_ref.code))
    np.testing.assert_allclose(np.asarray(op_cut.diag),
                               np.asarray(op_ref.diag), rtol=1e-12)
    # identical solve
    r = np.random.default_rng(0)
    b = jnp.asarray((r.normal(size=g.shape) * fluid).astype(np.float32))
    cfg = PoissonConfig(method="cg", tol=1e-6, max_iters=5000)
    p_cut, _, _ = solve_poisson(op_cut, b, jnp.zeros(g.shape), g, cfg)
    p_ref, _, _ = solve_poisson(op_ref, b, jnp.zeros(g.shape), g, cfg)
    np.testing.assert_allclose(np.asarray(p_cut), np.asarray(p_ref),
                               atol=2e-5)


def test_cut_operator_symmetric_and_constants_in_nullspace():
    g = GridSpec(shape=(24, 24), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    ap, fluid, _ = cutcell.cut_geometry(g, _disk_sdf(0.48, 0.52, 0.21))
    op = build_poisson_op_cut(g, bcs, ap, fluid)
    assert op.singular
    r = np.random.default_rng(1)
    fl = fluid.astype(np.float32)
    x = jnp.asarray(r.normal(size=g.shape).astype(np.float32) * fl)
    y = jnp.asarray(r.normal(size=g.shape).astype(np.float32) * fl)
    axy = float(jnp.sum(apply_A(op, x) * y * op.fluid))
    ayx = float(jnp.sum(apply_A(op, y) * x * op.fluid))
    assert abs(axy - ayx) < 1e-3 * max(1.0, abs(axy))
    # constants are in the nullspace over fluid cells (row sums 0)
    ones = jnp.asarray(fl)
    a1 = np.asarray(apply_A(op, ones) * op.fluid)
    # exact cancellation in f64; in f32 each row's +-alpha/h^2 terms leave
    # ~eps/h^2 roundoff (reconstructed apertures are arbitrary reals, not
    # the dyadic multiples the old counting estimator produced)
    tol = 8 * np.finfo(np.float32).eps / float(g.spacing[0]) ** 2
    assert np.abs(a1).max() < tol


def test_sharp_pressure_projection_exact():
    """With BOTH sides sharp (IBM velocity + cut-cell pressure), the
    projected field is divergence-free in the APERTURED sense at every
    fluid cell -- including the cut cells the staircase treatment gets
    wrong."""
    case = make_case(
        "cylinder", shape=(64, 32), lengths=(8.0, 4.0), re=40.0,
        center=(2.0, 2.03), poisson_method="mg", poisson_tol=1e-7,
        poisson_iters=200, poisson_extrapolate=0.0,
        ibm=True, sharp_pressure=True,
    )
    sim = case.sim
    assert sim.op.ap is not None and sim.ibm is not None
    st, d = sim.run_scan(case.initial_state(), 10)
    div = np.asarray(sim._div(st.u) * np.asarray(sim.op.fluid))
    # the last outlet columns carry the known post-correction zero-gradient
    # BC artifact (present identically in the staircase path); everywhere
    # else -- cut cells included -- the apertured projection is exact to
    # f32 epsilon (measured 1.2e-6 here)
    assert np.abs(div[:56]).max() < 5e-5, np.abs(div[:56]).max()
    assert np.isfinite(np.asarray(st.p)).all()
    for c in st.u:
        assert np.isfinite(np.asarray(c)).all()


def test_sharp_pressure_rejects_spectral_methods():
    import pytest

    with pytest.raises(ValueError, match="iterative"):
        make_case("cylinder", shape=(64, 32), lengths=(8.0, 4.0),
                  poisson_method="dctcg", ibm=True, sharp_pressure=True)


def test_apertures_exact_for_planar_cuts_2d():
    """The clipped linear reconstruction is EXACT for planar interfaces
    at any angle (ADVICE r3: the former midpoint counting was O(1/k) on
    cut faces), even at k=1."""
    g = GridSpec(shape=(16, 16), lengths=(1.0, 1.0))
    nx, ny, d0 = 0.6, 0.8, 0.37
    al = cutcell.face_apertures(g, lambda x, y: nx * x + ny * y - d0, k=1)
    h = 1.0 / 16
    for i in range(17):
        for j in range(16):
            x, y0, y1 = i * h, j * h, (j + 1) * h
            v0, v1 = nx * x + ny * y0 - d0, nx * x + ny * y1 - d0
            if v0 <= 0 and v1 <= 0:
                a = 0.0
            elif v0 > 0 and v1 > 0:
                a = 1.0
            else:
                a = max(v0, v1) / abs(v1 - v0)
            # the face-center closing + ALPHA_MIN postprocess
            if nx * x + ny * (y0 + y1) / 2 - d0 <= 0 or a < cutcell.ALPHA_MIN:
                a = 0.0
            assert abs(a - al[0][i, j]) < 1e-12, (i, j, a, al[0][i, j])


def test_apertures_exact_for_planar_cuts_3d():
    """3D rectangle apertures of a tilted plane match a dense midpoint
    reference far below the counting estimator's own error."""
    g = GridSpec(shape=(8, 8, 8), lengths=(1.0, 1.0, 1.0))
    n = np.array([0.48, 0.6, 0.64])
    n /= np.linalg.norm(n)
    sdf = lambda x, y, z: n[0] * x + n[1] * y + n[2] * z - 0.52  # noqa: E731
    al1 = cutcell.face_apertures(g, sdf, k=1)
    al_hi = cutcell.face_apertures(g, sdf, k=16)  # 16^2 subcells, each exact
    for a in range(3):
        np.testing.assert_allclose(al1[a], al_hi[a], atol=1e-12)


def test_apertures_second_order_on_circle():
    """On a smooth curved boundary each cut subcell carries the linear-
    interpolant's O((h/k)^2) error: doubling k cuts the max error ~4x."""
    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    circ = lambda x, y: np.hypot(x - 0.5, y - 0.5) - 0.31  # noqa: E731
    ref = cutcell.face_apertures(g, circ, k=64)
    errs = []
    for k in (1, 2, 4):
        a = cutcell.face_apertures(g, circ, k=k)
        errs.append(sum(np.abs(a[d] - ref[d]).sum() for d in range(2)))
    # summed error over all cut faces drops ~4x per doubling (the max
    # norm is noisier: a single worst face sits wherever the circle is
    # locally most curved relative to the subcell lattice)
    # measured sums: 0.124 / 0.050 / 0.014 (ratios 2.5x, 3.7x; the first
    # doubling is weakest because k=1 already resolves most faces exactly)
    assert errs[0] > 2.0 * errs[1]
    assert errs[1] > 3.0 * errs[2]
    maxe = max(np.abs(cutcell.face_apertures(g, circ, k=4)[d]
                      - ref[d]).max() for d in range(2))
    assert maxe < 2e-3
