"""Direct spectral (DCT) Poisson solver tests: DCT round-trip/orthogonality,
exactness vs the matrix-free operator, agreement with CG, and end-to-end
cavity physics with method='fft'."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu import GridSpec, no_slip_box
from navierstokessolver_tpu.bcs import BCSpec
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.ops import dct as dct_mod
from navierstokessolver_tpu.ops.fft_poisson import DCTPoissonSolver, is_applicable
from navierstokessolver_tpu.ops.poisson import (
    PoissonConfig,
    apply_A,
    build_poisson_op,
    solve_poisson,
)


@pytest.mark.parametrize("n", [8, 16, 12, 9])
def test_dct_roundtrip(n):
    r = np.random.default_rng(0)
    x = jnp.asarray(r.normal(size=(5, n)), jnp.float32)
    X = dct_mod.dct2(x, axis=1)
    back = dct_mod.idct2(X, axis=1)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-5)


def test_dct_matches_dense_definition():
    n = 10
    r = np.random.default_rng(1)
    x = r.normal(size=n)
    # dense DCT-II: X_k = 2 sum_i x_i cos(pi k (2i+1) / (2n))
    i = np.arange(n)
    dense = np.array([
        2.0 * (x * np.cos(np.pi * k * (2 * i + 1) / (2 * n))).sum()
        for k in range(n)
    ])
    ours = np.asarray(dct_mod.dct2(jnp.asarray(x, jnp.float32), axis=0))
    np.testing.assert_allclose(ours, dense, atol=1e-4)


def test_eigenvalue_identity():
    """A @ dct_mode == lambda * dct_mode for the all-Neumann operator."""
    g = GridSpec(shape=(16, 12), lengths=(1.0, 0.75))
    op = build_poisson_op(g, no_slip_box(g))
    kx, ky = 3, 5
    i = np.arange(g.shape[0])
    j = np.arange(g.shape[1])
    mode = np.cos(np.pi * kx * (2 * i[:, None] + 1) / (2 * g.shape[0])) * \
           np.cos(np.pi * ky * (2 * j[None, :] + 1) / (2 * g.shape[1]))
    lam = (dct_mod.neumann_eigenvalues(g.shape[0], g.spacing[0])[kx]
           + dct_mod.neumann_eigenvalues(g.shape[1], g.spacing[1])[ky])
    Am = np.asarray(apply_A(op, jnp.asarray(mode, g.dtype)))
    np.testing.assert_allclose(Am, lam * mode, atol=2e-3 * abs(lam))


def test_spectral_solve_is_exact():
    g = GridSpec(shape=(32, 24), lengths=(1.0, 1.0))
    op = build_poisson_op(g, no_slip_box(g))
    solver = DCTPoissonSolver.build(g)
    r = np.random.default_rng(2)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    p = solver.solve(jnp.asarray(b))
    res = np.asarray(apply_A(op, p)) - b
    rel = np.linalg.norm(res) / np.linalg.norm(b)
    assert rel < 5e-5, rel
    # agrees with CG up to constant
    p_cg, _, _ = solve_poisson(
        op, jnp.asarray(b), jnp.zeros(g.shape, g.dtype), g,
        PoissonConfig("cg", 1e-6, 10000),
    )
    d = np.asarray(p) - np.asarray(p_cg)
    d -= d.mean()
    assert np.abs(d).max() < 1e-4


def test_applicability_gate():
    g = GridSpec(shape=(8, 8), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    assert is_applicable(g, bcs, None)
    solid = np.zeros(g.shape, bool)
    solid[2, 2] = True
    assert not is_applicable(g, bcs, solid)
    # Outflow faces diagonalize too now (DCT-IV / DST-II axes); only an
    # interior obstacle breaks the tensor structure.
    bcs[(0, 1)] = BCSpec.outflow()
    assert is_applicable(g, bcs, None)
    assert not is_applicable(g, bcs, solid)


def test_cavity_with_fft_matches_cg():
    c1 = make_case("cavity", shape=(32, 32), poisson_method="fft")
    c2 = make_case("cavity", shape=(32, 32), poisson_method="cg",
                   poisson_tol=1e-6, poisson_iters=20000)
    s1, d1 = c1.sim.run_scan(c1.initial_state(), 100)
    s2, d2 = c2.sim.run_scan(c2.initial_state(), 100)
    np.testing.assert_allclose(
        np.asarray(s1.u[0]), np.asarray(s2.u[0]), atol=5e-4
    )
    assert int(d1.poisson_iters[-1]) == 1
    assert float(d1.max_div[-1]) < 1e-4


def test_3d_spectral_solve():
    g = GridSpec(shape=(12, 10, 8), lengths=(1.0, 1.0, 1.0))
    op = build_poisson_op(g, no_slip_box(g))
    solver = DCTPoissonSolver.build(g)
    r = np.random.default_rng(3)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    p = solver.solve(jnp.asarray(b))
    rel = np.linalg.norm(np.asarray(apply_A(op, p)) - b) / np.linalg.norm(b)
    assert rel < 1e-4, rel


def test_split_dct_matches_dense():
    """Radix-split DCT application == dense matmul, both directions, f64."""
    import jax
    from navierstokessolver_tpu.ops import dct as dct_mod

    rng = np.random.default_rng(5)
    for n, levels in [(32, 1), (64, 2), (64, 3)]:
        x = jnp.asarray(rng.normal(size=(n, 7)))
        plan = dct_mod.SplitPlan(n, levels, x.dtype)
        hi = jax.lax.Precision.HIGHEST
        dense = jnp.tensordot(
            jnp.asarray(dct_mod.dct2_matrix(n), x.dtype), x,
            axes=([1], [0]), precision=hi,
        )
        got = dct_mod.split_dct_apply(plan, x, 0, hi)
        # suite runs float32; split == dense to roundoff
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(dense), rtol=2e-6, atol=2e-5
        )
        back = dct_mod.split_idct_apply(plan, got, 0, hi)
        np.testing.assert_allclose(
            np.asarray(back), np.asarray(x), rtol=2e-6, atol=2e-5
        )


def test_split_dct_axis1():
    import jax
    from navierstokessolver_tpu.ops import dct as dct_mod

    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(5, 32)))
    plan = dct_mod.SplitPlan(32, 2, x.dtype)
    hi = jax.lax.Precision.HIGHEST
    dense = jnp.tensordot(
        jnp.asarray(dct_mod.dct2_matrix(32), x.dtype), x,
        axes=([1], [1]), precision=hi,
    )
    got = dct_mod.split_dct_apply(plan, x, 1, hi)
    np.testing.assert_allclose(np.asarray(got), np.asarray(dense), atol=2e-5)
    # after the forward, the transformed axis sits at position 0 (tensordot
    # convention); invert along it and compare against x transposed
    back = dct_mod.split_idct_apply(plan, got, 0, hi)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x).T, atol=2e-5)


def test_split_block_order_roundtrip():
    """block_order forward + permuted multiplier + block_order inverse ==
    natural-order pipeline (the runtime layout used by the solver)."""
    import jax
    from navierstokessolver_tpu.ops import dct as dct_mod

    rng = np.random.default_rng(7)
    n, lev = 64, 2
    x = jnp.asarray(rng.normal(size=(n, 5)).astype(np.float32))
    plan = dct_mod.SplitPlan(n, lev, x.dtype)
    hi = jax.lax.Precision.HIGHEST
    perm = dct_mod.split_permutation(n, lev)
    assert sorted(perm.tolist()) == list(range(n))
    Xb = dct_mod.split_dct_apply(plan, x, 0, hi, block_order=True)
    Xn = dct_mod.split_dct_apply(plan, x, 0, hi, block_order=False)
    np.testing.assert_allclose(
        np.asarray(Xb), np.asarray(Xn)[perm], atol=2e-4
    )
    back = dct_mod.split_idct_apply(plan, Xb, 0, hi, block_order=True)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=2e-5)


def test_self_check_passes_on_healthy_build():
    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    s = DCTPoissonSolver.build(g, periodic=(False, False))
    assert s._self_check_error(("nn", "nn")) < 0.05


def test_self_check_falls_back_to_dense_on_corrupt_split(monkeypatch):
    """VERDICT r1 item 8: a (simulated) shape-specific split-transform
    miscompile must be caught at build time and demoted to dense plans,
    not shipped as silently wrong physics."""
    real_apply = dct_mod.split_dct_apply

    def corrupt_apply(plan, x, axis, precision, level=0, block_order=False):
        out = real_apply(plan, x, axis, precision, level, block_order)
        if plan.levels > 0 and level == 0:
            out = out * 0.1  # catastrophic, like the n=256-3D miscompile
        return out

    monkeypatch.setattr(dct_mod, "split_dct_apply", corrupt_apply)
    import navierstokessolver_tpu.ops.fft_poisson as fp

    monkeypatch.setattr(fp.dct_mod, "split_dct_apply", corrupt_apply)
    g = GridSpec(shape=(64, 64), lengths=(1.0, 1.0))
    s = DCTPoissonSolver.build(g, split_levels=2, periodic=(False, False))
    assert all(p.levels == 0 for p in s.plans)
    assert s._self_check_error(("nn", "nn")) < 0.05


def test_self_check_raises_when_dense_also_corrupt(monkeypatch):
    import navierstokessolver_tpu.ops.fft_poisson as fp

    real_apply = dct_mod.split_dct_apply

    def corrupt_all(plan, x, axis, precision, level=0, block_order=False):
        return real_apply(plan, x, axis, precision, level, block_order) * 0.1

    monkeypatch.setattr(fp.dct_mod, "split_dct_apply", corrupt_all)
    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    with pytest.raises(RuntimeError, match="self-check failed"):
        DCTPoissonSolver.build(g, periodic=(False, False))
