"""Explicit shard_map+ppermute Poisson solve vs the single-device solvers
(SURVEY.md SS5 halo-exchange design)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu import GridSpec, no_slip_box
from navierstokessolver_tpu.bcs import BCSpec
from navierstokessolver_tpu.ops.poisson import (
    PoissonConfig,
    build_poisson_op,
    deflate,
    solve_poisson,
)
from navierstokessolver_tpu.parallel import make_mesh
from navierstokessolver_tpu.parallel.halo import ShardedPoissonSolver

# Heavy tier: compile-heavy shard_map solver programs, excluded from the
# default quick suite; run `pytest -m heavy` before commits touching
# parallel/halo.py.
pytestmark = pytest.mark.heavy

requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@requires_8
@pytest.mark.parametrize("method", ["jacobi", "sor", "cg"])
def test_sharded_solve_matches_single_device(method):
    g = GridSpec(shape=(64, 32), lengths=(1.0, 0.5))
    bcs = no_slip_box(g)
    op = build_poisson_op(g, bcs)
    mesh = make_mesh(8)
    cfg = PoissonConfig(method=method, tol=1e-5, max_iters=30000)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg)
    r = np.random.default_rng(0)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    b = jnp.asarray(b)
    p_sh, it_sh, res_sh = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res_sh) <= 1.1e-5, (method, float(res_sh), int(it_sh))
    p_ref, it_ref, _ = solve_poisson(op, b, jnp.zeros(g.shape, g.dtype), g, cfg)
    d = np.asarray(deflate(op, p_sh)) - np.asarray(deflate(op, p_ref))
    assert np.abs(d).max() < 5e-4, (method, np.abs(d).max())
    # really distributed
    assert len(p_sh.sharding.device_set) == 8


@requires_8
def test_sharded_solve_dirichlet_obstacle():
    g = GridSpec(shape=(64, 16), lengths=(2.0, 0.5))
    bcs = no_slip_box(g)
    bcs[(0, 1)] = BCSpec.outflow()
    solid = np.zeros(g.shape, bool)
    solid[24:32, 6:10] = True
    op = build_poisson_op(g, bcs, solid)
    mesh = make_mesh(8)
    cfg = PoissonConfig(method="cg", tol=1e-6, max_iters=20000)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg)
    r = np.random.default_rng(1)
    b = jnp.asarray((r.normal(size=g.shape) * ~solid).astype(np.float32))
    p_sh, _, res = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    p_ref, _, _ = solve_poisson(op, b, jnp.zeros(g.shape, g.dtype), g, cfg)
    assert float(res) < 1.1e-6
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_ref), atol=5e-4)


@requires_8
def test_build_rejects_bad_mesh():
    g = GridSpec(shape=(30, 16), lengths=(1.0, 0.5))  # 30 % 8 != 0
    op = build_poisson_op(g, no_slip_box(g))
    with pytest.raises(ValueError, match="divide"):
        ShardedPoissonSolver.build(g, op, make_mesh(8), PoissonConfig())


@requires_8
def test_sharded_solve_2d_pencil_mesh():
    """VERDICT r1 item 4: the explicit halo solver supports pencil (2D)
    meshes -- ppermute rings along BOTH grid axes."""
    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    op = build_poisson_op(g, no_slip_box(g))
    mesh = make_mesh((2, 4))
    cfg = PoissonConfig(method="cg", tol=1e-6, max_iters=20000)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg)
    r = np.random.default_rng(2)
    b = jnp.asarray(r.normal(size=g.shape).astype(np.float32))
    p_sh, it_sh, res = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res) < 1.1e-6
    p_ref, it_ref, _ = solve_poisson(op, b, jnp.zeros(g.shape, g.dtype), g, cfg)
    d = np.asarray(deflate(op, p_sh)) - np.asarray(deflate(op, p_ref))
    assert np.abs(d).max() < 5e-4
    assert len(p_sh.sharding.device_set) == 8


@requires_8
@pytest.mark.parametrize("method", ["sor", "cg"])
def test_sharded_solve_periodic_ring_ends(method):
    """Periodic axes close the ppermute ring with a wraparound link (the
    former NotImplementedError)."""
    import math

    g = GridSpec(shape=(64, 16), lengths=(2 * math.pi, 1.0))
    bcs = {(0, s): BCSpec.periodic() for s in (0, 1)}
    bcs.update({(1, s): BCSpec.wall((0.0, 0.0)) for s in (0, 1)})
    op = build_poisson_op(g, bcs)
    assert op.periodic[0] and not op.periodic[1]
    mesh = make_mesh(8)  # shards the PERIODIC axis
    cfg = PoissonConfig(method=method, tol=1e-5, max_iters=30000)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg)
    r = np.random.default_rng(3)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    b = jnp.asarray(b)
    p_sh, _, res = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res) <= 1.1e-5
    p_ref, _, _ = solve_poisson(op, b, jnp.zeros(g.shape, g.dtype), g, cfg)
    d = np.asarray(deflate(op, p_sh)) - np.asarray(deflate(op, p_ref))
    assert np.abs(d).max() < 5e-4


@requires_8
def test_simulation_halo_comm_matches_gspmd():
    """Production wiring: sharded_simulation(..., poisson_comm='halo')
    dispatches the explicit solver from Simulation._solve_pressure and the
    trajectory matches the GSPMD path and the single-device run."""
    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.parallel import (
        shard_state,
        sharded_simulation,
    )

    case = make_case("cavity", shape=(32, 32), poisson_method="cg",
                     poisson_tol=1e-6, poisson_iters=20000)
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 20)

    mesh = make_mesh(8)
    sim_halo = sharded_simulation(sim, mesh, poisson_comm="halo")
    assert sim_halo.halo_solver is not None
    st = shard_state(case.initial_state(), mesh, sim.grid)
    out, diag = sim_halo.run_scan(st, 20)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )
    np.testing.assert_allclose(np.asarray(out.p), np.asarray(ref.p), atol=5e-4)
    assert len(out.p.sharding.device_set) == 8

    sim_gspmd = sharded_simulation(sim, mesh, poisson_comm="gspmd")
    out2, _ = sim_gspmd.run_scan(
        shard_state(case.initial_state(), mesh, sim.grid), 20
    )
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(out2.u[0]), atol=5e-5
    )


@requires_8
@pytest.mark.parametrize("method", ["mg", "mgcg"])
def test_sharded_multigrid_matches_single_device(method):
    """VERDICT r2 item 4: the explicit-comm tier covers multigrid. Fine
    levels smooth block-local with ppermute ghosts; this 64x32 / 8-slab
    hierarchy stays sharded to the bottom (local coarse size 1)."""
    from navierstokessolver_tpu.ops.multigrid import MGPoissonSolver

    g = GridSpec(shape=(64, 32), lengths=(1.0, 0.5))
    bcs = no_slip_box(g)
    op = build_poisson_op(g, bcs)
    mg = MGPoissonSolver.build(g, bcs)
    mesh = make_mesh(8)
    cfg = PoissonConfig(method=method, tol=1e-5, max_iters=200)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg, mg=mg)
    r = np.random.default_rng(7)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    b = jnp.asarray(b)
    p_sh, it_sh, res_sh = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res_sh) <= 1.1e-5, (method, float(res_sh), int(it_sh))
    ref_solve = mg.solve_pcg if method == "mgcg" else mg.solve
    p_ref, it_ref, _ = ref_solve(b, jnp.zeros(g.shape, g.dtype), 1e-5, 200)
    d = np.asarray(deflate(op, p_sh)) - np.asarray(deflate(op, p_ref))
    assert np.abs(d).max() < 5e-4, (method, np.abs(d).max())
    # same convergence semantics: compare V-cycle/iteration counts
    assert abs(int(it_sh) - int(it_ref)) <= 1, (int(it_sh), int(it_ref))
    assert len(p_sh.sharding.device_set) == 8


@requires_8
def test_sharded_multigrid_gathered_coarse_levels():
    """48-wide axis over 8 devices: level-1 local size is odd (3), so the
    hierarchy splits -- levels 0..1 sharded, the rest replicated through
    the all_gather boundary. Exercises _gather_full/_slice_local."""
    from navierstokessolver_tpu.ops import multigrid
    from navierstokessolver_tpu.ops.poisson import ShardCtx

    g = GridSpec(shape=(48, 32), lengths=(1.5, 1.0))
    bcs = no_slip_box(g)
    op = build_poisson_op(g, bcs)
    mg = multigrid.MGPoissonSolver.build(g, bcs)
    ctx = ShardCtx(axes=("sx", None), sizes=(8, 1))
    split = multigrid.shard_split([tuple(o.diag.shape) for o in mg.ops], ctx)
    assert 0 < split < len(mg.ops), (split, len(mg.ops))
    mesh = make_mesh(8)
    cfg = PoissonConfig(method="mg", tol=1e-5, max_iters=200)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg, mg=mg)
    r = np.random.default_rng(8)
    b = r.normal(size=g.shape).astype(np.float32)
    b -= b.mean()
    b = jnp.asarray(b)
    p_sh, it_sh, res_sh = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res_sh) <= 1.1e-5, (float(res_sh), int(it_sh))
    p_ref, it_ref, _ = mg.solve(b, jnp.zeros(g.shape, g.dtype), 1e-5, 200)
    d = np.asarray(deflate(op, p_sh)) - np.asarray(deflate(op, p_ref))
    assert np.abs(d).max() < 5e-4, np.abs(d).max()
    assert abs(int(it_sh) - int(it_ref)) <= 1


@requires_8
def test_sharded_mgcg_pencil_obstacle_outflow():
    """mgcg over a (2,4) pencil mesh with an obstacle mask and an outflow
    (Dirichlet) face -- the topology multigrid exists for."""
    from navierstokessolver_tpu.ops.multigrid import MGPoissonSolver

    g = GridSpec(shape=(64, 32), lengths=(2.0, 1.0))
    bcs = no_slip_box(g)
    bcs[(0, 1)] = BCSpec.outflow()
    solid = np.zeros(g.shape, bool)
    solid[24:32, 12:20] = True
    op = build_poisson_op(g, bcs, solid)
    mg = MGPoissonSolver.build(g, bcs, solid)
    mesh = make_mesh((2, 4))
    cfg = PoissonConfig(method="mgcg", tol=1e-6, max_iters=200)
    solver = ShardedPoissonSolver.build(g, op, mesh, cfg, mg=mg)
    r = np.random.default_rng(9)
    b = jnp.asarray((r.normal(size=g.shape) * ~solid).astype(np.float32))
    p_sh, _, res = solver.solve(b, jnp.zeros(g.shape, g.dtype))
    assert float(res) < 1.1e-6
    p_ref, _, _ = mg.solve_pcg(b, jnp.zeros(g.shape, g.dtype), 1e-6, 200)
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_ref), atol=5e-4)
    assert len(p_sh.sharding.device_set) == 8


@requires_8
def test_simulation_halo_mg_matches_single_device():
    """Production wiring: poisson_comm='halo' now accepts mg -- the solver
    family production actually uses (VERDICT r2 item 4 'done' bar)."""
    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.parallel import (
        shard_state,
        sharded_simulation,
    )

    case = make_case("cavity", shape=(32, 32), poisson_method="mg",
                     poisson_tol=1e-6, poisson_iters=100)
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 15)

    mesh = make_mesh(8)
    sim_halo = sharded_simulation(sim, mesh, poisson_comm="halo")
    assert sim_halo.halo_solver is not None
    st = shard_state(case.initial_state(), mesh, sim.grid)
    out, diag = sim_halo.run_scan(st, 15)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )
    np.testing.assert_allclose(np.asarray(out.p), np.asarray(ref.p), atol=5e-4)
    assert len(out.p.sharding.device_set) == 8
