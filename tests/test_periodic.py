"""Periodic BC path: operator wrap couplings, circulant spectral solve, and
the Taylor-Green vortex analytic-decay oracle (SURVEY.md SS4 tier model:
physics ground truth beats ported tests)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu import GridSpec
from navierstokessolver_tpu.bcs import BCSpec, validate_bcs
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.cases.taylor_green import taylor_green_state
from navierstokessolver_tpu.ops import dct as dct_mod
from navierstokessolver_tpu.ops.poisson import (
    PoissonConfig,
    apply_A,
    build_poisson_op,
    solve_poisson,
)


def _periodic_box(shape=(16, 16), lengths=(2 * math.pi, 2 * math.pi)):
    g = GridSpec(shape=shape, lengths=lengths)
    bcs = {(a, s): BCSpec.periodic() for a in range(2) for s in (0, 1)}
    return g, bcs


def test_validate_rejects_one_sided_periodic():
    g, bcs = _periodic_box()
    bcs[(0, 1)] = BCSpec.wall((0.0, 0.0))
    with pytest.raises(ValueError, match="both faces"):
        validate_bcs(g, bcs)


def test_validate_rejects_odd_periodic():
    g = GridSpec(shape=(15, 16), lengths=(1.0, 1.0))
    bcs = {(a, s): BCSpec.periodic() for a in range(2) for s in (0, 1)}
    with pytest.raises(ValueError, match="even"):
        validate_bcs(g, bcs)


def test_periodic_operator_wraps():
    """A p for a plane wave matches the circulant eigenvalue exactly,
    including at the wrap boundary."""
    g, bcs = _periodic_box((16, 12), (1.0, 1.0))
    op = build_poisson_op(g, bcs)
    k = 3
    j = np.arange(16)
    mode = np.cos(2 * np.pi * k * j / 16)[:, None] * np.ones((1, 12))
    lam = -(4.0 / g.spacing[0] ** 2) * np.sin(np.pi * k / 16) ** 2
    Am = np.asarray(apply_A(op, jnp.asarray(mode, g.dtype)))
    np.testing.assert_allclose(Am, lam * mode, atol=1e-3 * abs(lam))


def test_periodic_circulant_solve_exact():
    from navierstokessolver_tpu.ops.fft_poisson import DCTPoissonSolver

    g, bcs = _periodic_box((32, 24), (1.0, 1.0))
    op = build_poisson_op(g, bcs)
    solver = DCTPoissonSolver.build(g, periodic=(True, True))
    r = np.random.default_rng(2)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    p = solver.solve(jnp.asarray(b))
    rel = np.linalg.norm(np.asarray(apply_A(op, p)) - b) / np.linalg.norm(b)
    assert rel < 5e-5, rel
    # iterative methods agree on the same operator
    p_cg, _, _ = solve_poisson(
        op, jnp.asarray(b), jnp.zeros(g.shape, g.dtype), g,
        PoissonConfig("cg", 1e-6, 20000),
    )
    d = np.asarray(p) - np.asarray(p_cg)
    d -= d.mean()
    assert np.abs(d).max() < 2e-4


def test_periodic_mixed_with_dct_axis():
    """Periodic x, walls y: mixed circulant x DCT diagonalization."""
    from navierstokessolver_tpu.bcs import no_slip_box
    from navierstokessolver_tpu.ops.fft_poisson import DCTPoissonSolver

    g = GridSpec(shape=(32, 24), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    bcs[(0, 0)] = BCSpec.periodic()
    bcs[(0, 1)] = BCSpec.periodic()
    op = build_poisson_op(g, bcs)
    solver = DCTPoissonSolver.build(g, periodic=(True, False))
    r = np.random.default_rng(3)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    p = solver.solve(jnp.asarray(b))
    rel = np.linalg.norm(np.asarray(apply_A(op, p)) - b) / np.linalg.norm(b)
    assert rel < 5e-5, rel


@pytest.mark.parametrize("method", ["fft", "cg"])
def test_taylor_green_decay(method):
    """Numerical TG vortex tracks the analytic solution (64^2, nu = 1/100)."""
    case = make_case("taylor_green", shape=(64, 64), re=100.0,
                     poisson_method=method)
    sim = case.sim
    nu = sim.params.nu
    dt = sim.params.dt
    n_steps = 200
    st = case.initial_state()
    st, diag = sim.run_scan(st, n_steps)
    assert float(diag.max_div[-1]) < 1e-4
    exact = taylor_green_state(sim.grid, n_steps * dt, nu)
    err_u = float(jnp.max(jnp.abs(st.u[0] - exact.u[0])))
    err_v = float(jnp.max(jnp.abs(st.u[1] - exact.u[1])))
    # amplitude at t: exp(-2*nu*t); errors are O(h^2 + dt)
    amp = math.exp(-2 * nu * n_steps * dt)
    assert err_u < 0.02 * amp, (err_u, amp)
    assert err_v < 0.02 * amp, (err_v, amp)


def test_taylor_green_energy_decay_rate():
    """Kinetic energy decays at exp(-4 nu t) to a few percent."""
    case = make_case("taylor_green", shape=(64, 64), re=50.0)
    sim = case.sim
    st = case.initial_state()
    e0 = float(sum(jnp.sum(c * c) for c in st.u))
    n = 150
    st, _ = sim.run_scan(st, n)
    e1 = float(sum(jnp.sum(c * c) for c in st.u))
    t = n * sim.params.dt
    expected = math.exp(-4.0 * sim.params.nu * t)
    assert abs(e1 / e0 - expected) < 0.03 * expected


def test_taylor_green_mg():
    """Multigrid handles the fully periodic operator (wrap prolongation)."""
    case = make_case("taylor_green", shape=(32, 32), re=100.0,
                     poisson_method="mg")
    st, diag = case.sim.run_scan(case.initial_state(), 30)
    assert float(diag.max_div[-1]) < 1e-4
    assert np.isfinite(np.asarray(st.p)).all()


def test_periodic_channel_poiseuille_persists():
    """Body-force-driven periodic channel: the Poiseuille parabola is a
    steady state of the discrete system (mixed circulant x DCT solve)."""
    case = make_case("channel_periodic", shape=(32, 32), re=50.0)
    st0 = case.initial_state()
    st, diag = case.sim.run_scan(st0, 200)
    assert float(diag.max_div[-1]) < 1e-4
    drift = float(jnp.max(jnp.abs(st.u[0] - st0.u[0])))
    assert drift < 5e-3, drift
    # cross-stream velocity stays negligible
    assert float(jnp.max(jnp.abs(st.u[1]))) < 1e-4


def test_circulant_split_matches_dense():
    """Symmetric-fold circulant split == dense eigenbasis matmul (both
    directions, block order + permutation round trip)."""
    import jax

    n = 64
    plan = dct_mod.CircSplitPlan(n, jnp.float32)
    Q, lam = dct_mod.circulant_eigenbasis(n, 1.0 / n)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(n, 5)).astype(np.float32))
    hi = jax.lax.Precision.HIGHEST
    dense = jnp.tensordot(jnp.asarray(Q.T, x.dtype), x, axes=([1], [0]),
                          precision=hi)
    got = plan.apply_fwd(x, 0, hi)
    perm = plan.permutation()
    assert sorted(perm.tolist()) == list(range(n))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(dense)[perm], atol=3e-5
    )
    back = plan.apply_inv(got, 0, hi)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=3e-5)


def test_circulant_split_solver_path():
    """Full periodic solve with the split plan forced on a small grid."""
    from navierstokessolver_tpu.ops import fft_poisson

    g, bcs = _periodic_box((32, 32), (1.0, 1.0))
    op = build_poisson_op(g, bcs)
    # swap in CircSplitPlans to exercise the split path at small n
    solver = fft_poisson.DCTPoissonSolver.build(g, periodic=(True, True))
    plans = tuple(dct_mod.CircSplitPlan(32, g.dtype) for _ in range(2))
    import numpy as _np
    inv = _np.zeros(g.shape)
    lam = [dct_mod.circulant_eigenbasis(n, h)[1]
           for n, h in zip(g.shape, g.spacing)]
    tot = lam[0][:, None] + lam[1][None, :]
    nz = tot != 0
    inv[nz] = 1.0 / tot[nz]
    inv = inv.T
    for j, a in enumerate((1, 0)):
        inv = _np.take(inv, plans[a].permutation(), axis=j)
    import dataclasses
    solver = dataclasses.replace(
        solver, plans=plans, inv_eig=jnp.asarray(inv, g.dtype)
    )
    r = np.random.default_rng(9)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    p = solver.solve(jnp.asarray(b), op)
    rel = np.linalg.norm(np.asarray(apply_A(op, p)) - b) / np.linalg.norm(b)
    assert rel < 5e-5, rel


def test_taylor_green3d_case():
    """3D TGV: discretely divergence-free start, energy decays, and the
    projection keeps the field divergence-free."""
    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.ops import stencils

    case = make_case("taylor_green3d", shape=(16, 16, 128), re=400.0)
    sim = case.sim
    st = case.initial_state()
    assert float(abs(stencils.divergence(sim.grid, st.u)).max()) < 1e-5
    e0 = sum(float((np.asarray(c) ** 2).sum()) for c in st.u)
    st, d = sim.run_scan(st, 20)
    e1 = sum(float((np.asarray(c) ** 2).sum()) for c in st.u)
    assert e1 < e0 and np.isfinite(e1)
    assert float(d.max_div[-1]) < 1e-5
