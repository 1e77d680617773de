"""Distributed tier (SURVEY.md SS4): 1-device vs n-device sharded runs agree
on the same config, on a virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.parallel import (
    make_mesh,
    shard_state,
    sharded_simulation,
)


requires_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@requires_8
def test_1d_decomposition_matches_single_device():
    case = make_case("cavity", shape=(32, 32))
    sim = case.sim
    st = case.initial_state()
    ref, diag_ref = sim.run_scan(st, 30)

    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    st_sh = shard_state(case.initial_state(), mesh, sim.grid)
    out, diag = sim_sh.run_scan(st_sh, 30)

    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.u[1]), np.asarray(ref.u[1]), atol=5e-5
    )
    np.testing.assert_allclose(np.asarray(out.p), np.asarray(ref.p), atol=5e-4)
    # Output really is sharded over the mesh (not silently gathered).
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_2d_pencil_decomposition():
    case = make_case("cavity", shape=(32, 32))
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 10)

    mesh = make_mesh((2, 4))
    sim_sh = sharded_simulation(sim, mesh)
    st_sh = shard_state(case.initial_state(), mesh, sim.grid)
    out, _ = sim_sh.run_scan(st_sh, 10)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_obstacle_case_sharded():
    case = make_case(
        "cylinder", shape=(96, 48), lengths=(12.0, 6.0), center=(3.0, 3.01)
    )
    sim = case.sim
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, _ = sim.run_scan(st, 10)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(shard_state(st, mesh, sim.grid), 10)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
    )


@requires_8
def test_3d_decomposition():
    case = make_case("cavity3d", shape=(16, 16, 16), re=100.0)
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 5)
    mesh = make_mesh((2, 2, 2))
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(shard_state(case.initial_state(), mesh, sim.grid), 5)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )


@requires_8
def test_scalar_transport_sharded():
    """Scalar-carrying states shard too: theta shares p's cell-centered
    decomposition, and the 8-device heated cavity matches single-device."""
    case = make_case("heated_cavity", shape=(32, 32), ra=1e3)
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 30)

    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    st_sh = shard_state(case.initial_state(), mesh, sim.grid)
    out, _ = sim_sh.run_scan(st_sh, 30)

    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(ref.theta), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.u[1]), np.asarray(ref.u[1]), atol=5e-5
    )
    assert len(out.theta.sharding.device_set) == 8


@requires_8
def test_les_sharded_matches_single_device():
    """The Smagorinsky closure is plain jnp stencil work, so it must ride
    the GSPMD domain decomposition unchanged."""
    case = make_case("decaying_turbulence", shape=(32, 32), re=20_000.0,
                     seed=5, les_cs=0.17)
    sim = case.sim
    assert sim.les is not None
    ref, _ = sim.run_scan(case.initial_state(), 15)

    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    assert sim_sh.les is not None  # survives the sharded rebuild
    st_sh = shard_state(case.initial_state(), mesh, sim.grid)
    out, _ = sim_sh.run_scan(st_sh, 15)
    for a in range(2):
        np.testing.assert_allclose(
            np.asarray(out.u[a]), np.asarray(ref.u[a]), atol=5e-5
        )


@requires_8
def test_tracers_sharded_matches_single_device():
    """Tracer advection reads the (sharded) velocity through gathers; the
    replicated particle ensemble must trace the same paths."""
    from navierstokessolver_tpu.tracers import seed_tracers

    case = make_case("cavity", shape=(32, 32))
    sim = case.sim
    pos0 = seed_tracers(sim.grid, 16, seed=7)
    _, pos_ref, _, traj_ref = sim.run_scan_tracers(
        case.initial_state(), pos0, 10
    )

    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    st_sh = shard_state(case.initial_state(), mesh, sim.grid)
    _, pos_sh, _, traj_sh = sim_sh.run_scan_tracers(st_sh, pos0, 10)
    np.testing.assert_allclose(
        np.asarray(traj_sh), np.asarray(traj_ref), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(pos_sh), np.asarray(pos_ref), atol=1e-5
    )


@requires_8
def test_heated_cylinder_sharded_matches_single_device():
    """scalar + immersed obstacle under GSPMD: the scalar_solid mask and
    the masked interface fluxes shard transparently; the sharded
    trajectory (theta included) matches the single-device run."""
    case = make_case("heated_cylinder", shape=(64, 32), re=20.0,
                     poisson_method="mg")
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 20)
    mesh = make_mesh(4)
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(
        shard_state(case.initial_state(), mesh, sim.grid), 20
    )
    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(ref.theta), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=5e-5
    )


@requires_8
def test_dctcg_sharded_matches_single_device():
    """dctcg -- the PRODUCTION obstacle solver (cylinder/sphere default,
    the flagship iterative datapoint) -- under GSPMD (VERDICT r3 missing
    #1): 1-vs-8 parity of the fields AND the Poisson diagnostics. The
    capacitance-corrected Richardson path is pure jnp (transform matmuls
    + while_loop), so GSPMD partitions it; this pins that it actually
    does, with the same convergence trajectory."""
    case = make_case(
        "cylinder", shape=(96, 48), lengths=(12.0, 6.0), center=(3.0, 3.01)
    )
    sim = case.sim
    assert sim.dctcg_solver is not None          # really runs dctcg
    assert sim.dctcg_solver.cap_cinv is not None  # capacitance/Richardson
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, diag_ref = sim.run_scan(st, 10)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, diag = sim_sh.run_scan(shard_state(st, mesh, sim.grid), 10)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out.p), np.asarray(ref.p), atol=1e-3
    )
    # Same convergence trajectory: identical sweep counts (up to one
    # reduction-order flip at the tol threshold) and matching residuals.
    it_ref = np.asarray(diag_ref.poisson_iters)
    it_sh = np.asarray(diag.poisson_iters)
    assert np.max(np.abs(it_sh - it_ref)) <= 1, (it_sh, it_ref)
    np.testing.assert_allclose(
        np.asarray(diag.poisson_res), np.asarray(diag_ref.poisson_res),
        atol=2e-6,
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_dctcg_pencil_sharded():
    """dctcg on a 2D ('sx','sy') pencil mesh: the transform matmuls
    contract along BOTH sharded grid axes (all-gather/reduce-scatter per
    axis under GSPMD)."""
    case = make_case(
        "cylinder", shape=(96, 48), lengths=(12.0, 6.0), center=(3.0, 3.01)
    )
    sim = case.sim
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, _ = sim.run_scan(st, 6)
    mesh = make_mesh((2, 4))
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(shard_state(st, mesh, sim.grid), 6)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_dctcg_singular_sharded():
    """The OTHER dctcg branch -- pure-Neumann (singular) topology, where
    Woodbury is unavailable and the plain spectral preconditioner drives
    flexible_pcg -- sharded vs single-device, scalar+obstacle+buoyancy
    riding along (heated enclosure with method overridden to dctcg)."""
    case = make_case("heated_enclosure", shape=(32, 32), ra=1e4,
                     poisson_method="dctcg")
    sim = case.sim
    assert sim.dctcg_solver is not None
    assert sim.dctcg_solver.cap_cinv is None      # singular: no Woodbury
    ref, diag_ref = sim.run_scan(case.initial_state(), 10)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, diag = sim_sh.run_scan(
        shard_state(case.initial_state(), mesh, sim.grid), 10
    )
    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(ref.theta), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.u[1]), np.asarray(ref.u[1]), atol=5e-5
    )
    it_ref = np.asarray(diag_ref.poisson_iters)
    it_sh = np.asarray(diag.poisson_iters)
    assert np.max(np.abs(it_sh - it_ref)) <= 2, (it_sh, it_ref)


@requires_8
def test_dctcg_halo_matches_single_device():
    """dctcg through the EXPLICIT-comm tier (round 4, VERDICT r3 item 2
    real target): poisson_comm='halo' routes the capacitance-Richardson
    solve into shard_map -- local dense transforms around one all-to-all
    pencil transpose per direction, the Woodbury sample as one (k0, 2K)
    psum, ctx-aware residuals. Fields AND the convergence trajectory
    match single-device."""
    case = make_case(
        "cylinder", shape=(96, 48), lengths=(12.0, 6.0), center=(3.0, 3.01)
    )
    sim = case.sim
    assert sim.dctcg_solver is not None
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, dref = sim.run_scan(st, 10)
    mesh = make_mesh(8)
    sim_h = sharded_simulation(sim, mesh, poisson_comm="halo")
    assert sim_h.halo_solver is not None
    assert sim_h.halo_solver.dctcg_consts is not None
    out, d = sim_h.run_scan(shard_state(st, mesh, sim.grid), 10)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
    )
    it_ref = np.asarray(dref.poisson_iters)
    it_h = np.asarray(d.poisson_iters)
    assert np.max(np.abs(it_h - it_ref)) <= 1, (it_h, it_ref)
    np.testing.assert_allclose(
        np.asarray(d.poisson_res), np.asarray(dref.poisson_res), atol=2e-6
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_dctcg_halo_singular_matches_single_device():
    """The singular dctcg branch (pure-Neumann enclosure: no Woodbury,
    spectral preconditioner drives ctx-aware flexible_pcg) through the
    explicit-halo tier."""
    case = make_case("heated_enclosure", shape=(32, 32), ra=1e4,
                     poisson_method="dctcg")
    sim = case.sim
    assert sim.dctcg_solver.cap_cinv is None
    ref, dref = sim.run_scan(case.initial_state(), 10)
    mesh = make_mesh(8)
    sim_h = sharded_simulation(sim, mesh, poisson_comm="halo")
    out, d = sim_h.run_scan(
        shard_state(case.initial_state(), mesh, sim.grid), 10
    )
    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(ref.theta), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.u[1]), np.asarray(ref.u[1]), atol=5e-5
    )
    it_ref = np.asarray(dref.poisson_iters)
    it_h = np.asarray(d.poisson_iters)
    assert np.max(np.abs(it_h - it_ref)) <= 2, (it_h, it_ref)


@requires_8
def test_cutcell_sharp_pressure_sharded_2d():
    """Cut-cell apertured pressure (sharp_pressure) under GSPMD: the
    apertured operator/divergence/correction triple is plain jnp over
    static replicated aperture arrays, so the sharded jnp step partitions
    it like any stencil -- 1-vs-8 slab parity on the IBM+sharp cylinder
    (SURVEY SS2 obstacle row x SS5 comm backend: the sharp-interface
    production solver's multi-chip story, mirroring r3's dctcg ask)."""
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    case = make_case("cylinder", shape=(96, 48), lengths=(12.0, 6.0),
                     center=(3.0, 3.01), ibm=True, sharp_pressure=True,
                     poisson_method="cg")
    sim = case.sim
    st = impulsive_start_state(sim)
    ref, _ = sim.run_scan(st, 10)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(shard_state(st, mesh, sim.grid), 10)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_cutcell_sharp_pressure_sharded_3d_pencil():
    """3D sphere with sharp pressure + mg, slab AND pencil meshes vs the
    single-device run (the sharded jnp step; fused tiers document the
    aperture fallback in docs/SCALING.md known limits)."""
    case = make_case("sphere", shape=(32, 16, 16), lengths=(8.0, 4.0, 4.0),
                     center=(2.0, 2.01, 2.02), ibm=True, sharp_pressure=True,
                     poisson_method="mg")
    sim = case.sim
    ref, _ = sim.run_scan(case.initial_state(), 8)
    for spec in (8, (2, 4)):
        mesh = make_mesh(spec)
        sim_sh = sharded_simulation(sim, mesh)
        out, _ = sim_sh.run_scan(
            shard_state(case.initial_state(), mesh, sim.grid), 8
        )
        np.testing.assert_allclose(
            np.asarray(out.u[0]), np.asarray(ref.u[0]), atol=1e-4
        )


@requires_8
def test_timedep_bc_values_sharded():
    """Time-dependent BC VALUES under GSPMD: sharded runs resolve the
    callables inside the jitted scan exactly like unsharded ones; 1-vs-8
    parity on the oscillating-lid cavity, t carried and equal."""
    import jax.numpy as jnp

    from navierstokessolver_tpu.bcs import BCSpec, no_slip_box
    from navierstokessolver_tpu.grid import GridSpec
    from navierstokessolver_tpu.ops.poisson import PoissonConfig
    from navierstokessolver_tpu.solver import SimParams, Simulation

    grid = GridSpec(shape=(16, 16, 16), lengths=(1.0, 1.0, 1.0))
    bcs = no_slip_box(grid)
    bcs[(0, 1)] = BCSpec.wall(
        (0.0, lambda t: jnp.cos(2.0 * jnp.pi * t), 0.0)
    )
    params = SimParams(
        dt=2e-3, nu=0.01,
        poisson=PoissonConfig(method="cg", tol=1e-6, max_iters=500),
    )
    sim = Simulation.build(grid, bcs, params)
    ref, _ = sim.run_scan(sim.initial_state(), 10)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(
        shard_state(sim.initial_state(), mesh, sim.grid), 10
    )
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(out.u[c]), np.asarray(ref.u[c]), atol=1e-4
        )
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-6)


@requires_8
def test_dctcg_sphere3d_sharded_matches_single_device():
    """The 3D sphere capacitance dctcg path (the production 512x256x256
    config's class -- docs/PARITY.md 1058-MLUPS datapoint) under GSPMD,
    1-vs-8 slab parity incl. the convergence trajectory (VERDICT r4 item
    4 minimum)."""
    case = make_case("sphere", shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0),
                     center=(4.0, 4.1, 3.9), diameter=1.6, re=100.0)
    sim = case.sim
    assert sim.dctcg_solver is not None
    assert sim.dctcg_solver.cap_cinv is not None   # capacitance branch
    assert sim.dctcg_solver.cap_wbox is not None   # generic 3D box form
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, dref = sim.run_scan(st, 8)
    mesh = make_mesh(8)
    sim_sh = sharded_simulation(sim, mesh)
    out, d = sim_sh.run_scan(shard_state(st, mesh, sim.grid), 8)
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(out.u[a]), np.asarray(ref.u[a]), atol=1e-4
        )
    np.testing.assert_allclose(np.asarray(out.p), np.asarray(ref.p),
                               atol=1e-3)
    it_ref = np.asarray(dref.poisson_iters)
    it_sh = np.asarray(d.poisson_iters)
    assert np.max(np.abs(it_sh - it_ref)) <= 1, (it_sh, it_ref)
    np.testing.assert_allclose(
        np.asarray(d.poisson_res), np.asarray(dref.poisson_res), atol=2e-6
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_dctcg_halo_3d_matches_single_device():
    """Explicit-comm dctcg for the 3D sphere (round 5, VERDICT r4 item 4
    real target): poisson_comm='halo' runs the distributed 3D spectral
    preconditioner (local axes-1/2 dense transforms around one
    all-to-all pencil transpose per direction) with the capacitance box
    gathered/scattered across shards by a one-hot row map + one box
    psum. Fields AND convergence trajectory match single-device."""
    case = make_case("sphere", shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0),
                     center=(4.0, 4.1, 3.9), diameter=1.6, re=100.0)
    sim = case.sim
    assert sim.dctcg_solver.cap_wbox is not None
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    st = impulsive_start_state(sim)
    ref, dref = sim.run_scan(st, 8)
    mesh = make_mesh(8)
    sim_h = sharded_simulation(sim, mesh, poisson_comm="halo")
    assert sim_h.halo_solver is not None
    assert sim_h.halo_solver.dctcg_consts is not None
    assert "wflat" in sim_h.halo_solver.dctcg_consts   # 3D box form
    out, d = sim_h.run_scan(shard_state(st, mesh, sim.grid), 8)
    for a in range(3):
        np.testing.assert_allclose(
            np.asarray(out.u[a]), np.asarray(ref.u[a]), atol=1e-4
        )
    it_ref = np.asarray(dref.poisson_iters)
    it_h = np.asarray(d.poisson_iters)
    assert np.max(np.abs(it_h - it_ref)) <= 1, (it_h, it_ref)
    # stopping-point residuals are f32-noise-sensitive through the two
    # distributed spectral solves; trajectory equality is pinned by the
    # sweep counts above -- residuals agree to the noise level
    np.testing.assert_allclose(
        np.asarray(d.poisson_res), np.asarray(dref.poisson_res), atol=5e-6
    )
    assert len(out.p.sharding.device_set) == 8


@requires_8
def test_timedep_masked_sharded_falls_back_to_jnp():
    """Obstacle masks + time-dependent BC values under sharding: the GSPMD
    step must match single-device."""
    import jax.numpy as jnp

    from navierstokessolver_tpu.bcs import BCSpec, no_slip_box
    from navierstokessolver_tpu.grid import GridSpec
    from navierstokessolver_tpu.ops.poisson import PoissonConfig
    from navierstokessolver_tpu.solver import SimParams, Simulation

    grid = GridSpec(shape=(32, 16, 16), lengths=(2.0, 1.0, 1.0))
    bcs = no_slip_box(grid)
    bcs[(2, 1)] = BCSpec.wall((lambda t: jnp.cos(4.0 * t), 0.0, 0.0))
    solid = np.zeros(grid.shape, bool)
    solid[14:18, 6:10, 6:10] = True
    params = SimParams(
        dt=2e-3, nu=0.01,
        poisson=PoissonConfig(method="mg", tol=1e-6, max_iters=80),
    )
    sim = Simulation.build(grid, bcs, params, solid=solid)
    ref, _ = sim.run_scan(sim.initial_state(), 6)
    mesh = make_mesh(4)
    sim_sh = sharded_simulation(sim, mesh)
    out, _ = sim_sh.run_scan(
        shard_state(sim.initial_state(), mesh, sim.grid), 6
    )
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(out.u[c]), np.asarray(ref.u[c]), atol=1e-4
        )
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-6)
