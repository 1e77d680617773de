"""Time-dependent boundary values and forcing (State.t carried through
the scan): exact semi-discrete Womersley oracle, oscillating-lid
equivalence with per-step static re-builds, checkpoint round-trip."""

import jax.numpy as jnp
import numpy as np

from navierstokessolver_tpu.bcs import BCSpec, no_slip_box
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops.poisson import PoissonConfig
from navierstokessolver_tpu.solver import SimParams, Simulation


def test_pulsatile_channel_matches_exact_semidiscrete():
    """f_x(t) = A cos(omega t) in a periodic channel: u(y, t) stays
    x-uniform with v = 0, so each eigenmode of the DISCRETE wall-bounded
    Laplacian obeys dc/dt = -nu lam c + A_k cos(omega t) exactly, whose
    solution from rest is closed-form. The only solver error left is time
    discretization (rk2: O(dt^2)) -- the oracle is exact otherwise,
    transient included."""
    ny = 32
    case = make_case("pulsatile_channel", shape=(8, ny), womersley=4.0,
                     integrator="rk2")
    sim = case.sim
    nu = sim.params.nu
    omega = 2.0 * np.pi
    amp = 1.0
    dt = sim.params.dt
    n_steps = int(0.8 / dt)
    st, diag = sim.run_scan(case.initial_state(), n_steps)
    t_end = float(st.t)
    np.testing.assert_allclose(t_end, n_steps * dt, rtol=1e-5)

    # exact semi-discrete reference: discrete Laplacian for u at the
    # x-face points (cell-centered in y), no-slip ghosts u_g = -u_edge
    h = sim.grid.spacing[1]
    L = np.zeros((ny, ny))
    for j in range(ny):
        L[j, j] = -2.0
        if j > 0:
            L[j, j - 1] = 1.0
        if j < ny - 1:
            L[j, j + 1] = 1.0
    L[0, 0] -= 1.0      # ghost reflection: u(-1) = -u(0)
    L[-1, -1] -= 1.0
    L /= h * h
    lam, V = np.linalg.eigh(L)          # lam < 0
    a_k = V.T @ np.ones(ny)             # forcing projects uniformly
    d = -nu * lam                       # decay rates (> 0)
    t = t_end
    c = a_k * amp * (
        (d * np.cos(omega * t) + omega * np.sin(omega * t)
         - d * np.exp(-d * t)) / (d * d + omega * omega)
    )
    u_exact = V @ c

    u = np.asarray(st.u[0])[: sim.grid.shape[0], :]
    # x-uniformity (no advection, no pressure response)
    assert np.max(np.abs(u - u[0:1, :])) < 1e-6
    scale = np.max(np.abs(u_exact)) + 1e-30
    err = np.max(np.abs(u[0] - u_exact)) / scale
    assert err < 2e-3, err


def test_oscillating_lid_matches_per_step_static_rebuild():
    """A callable lid velocity must reproduce the trajectory of manually
    re-building a static Simulation with the lid evaluated at each step's
    start time."""
    n = 16
    g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
    omega = 3.0

    def lid(t):
        return 0.5 + 0.5 * jnp.sin(omega * t)

    params = SimParams(
        dt=2e-3, nu=0.05,
        poisson=PoissonConfig(method="cg", tol=1e-7, max_iters=400),
    )
    bcs_td = no_slip_box(g)
    bcs_td[(1, 1)] = BCSpec.wall((lid, 0.0))
    sim_td = Simulation.build(g, bcs_td, params)
    assert sim_td._time_dependent()
    st_td = sim_td.initial_state()
    assert st_td.t is not None
    n_steps = 25
    out_td, diag = sim_td.run_scan(st_td, n_steps)

    # manual per-step rebuild with concrete lid values
    st = None
    for k in range(n_steps):
        bcs_k = no_slip_box(g)
        bcs_k[(1, 1)] = BCSpec.wall((float(lid(k * params.dt)), 0.0))
        sim_k = Simulation.build(g, bcs_k, params)
        if st is None:
            st = sim_k.initial_state()
        st, _ = sim_k.step(st)
    for c in range(2):
        np.testing.assert_allclose(
            np.asarray(out_td.u[c]), np.asarray(st.u[c]), atol=2e-6
        )
    np.testing.assert_allclose(float(out_td.t), n_steps * params.dt,
                               rtol=1e-5)


def test_timedep_checkpoint_roundtrip():
    """t survives checkpoint/resume and the resumed run matches an
    unbroken one."""
    import os
    import tempfile

    from navierstokessolver_tpu import io as io_mod

    case = make_case("pulsatile_channel", shape=(8, 16), womersley=3.0)
    sim = case.sim
    st0 = case.initial_state()
    mid, _ = sim.run_scan(st0, 10)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck.npz")
        io_mod.save_checkpoint(path, mid, 10, "h")
        loaded, step = io_mod.load_checkpoint(path, sim.grid)
    assert step == 10 and loaded.t is not None
    np.testing.assert_allclose(float(loaded.t), float(mid.t), rtol=1e-6)
    cont, _ = sim.run_scan(loaded, 10)
    full, _ = sim.run_scan(st0, 20)
    for c in range(2):
        np.testing.assert_allclose(
            np.asarray(cont.u[c]), np.asarray(full.u[c]), atol=1e-6
        )


def test_traced_convective_phase_speed_falls_back_to_jnp():
    """A CALLABLE convective phase speed resolves to a tracer inside the
    jitted scan; the step must accept the traced scalar
    (apply_convective_outlets keeps it symbolic). A constant callable must
    reproduce the static run exactly."""
    from navierstokessolver_tpu.bcs import BCKind, BCSpec, no_slip_box

    g = GridSpec(shape=(16, 16, 16), lengths=(1.0, 1.0, 1.0))
    params = SimParams(
        dt=2e-3, nu=0.01,
        poisson=PoissonConfig(method="cg", tol=1e-6, max_iters=400),
    )
    speed = 0.7

    def bcs_with(conv_speed_entry):
        bcs = no_slip_box(g)
        bcs[(0, 0)] = BCSpec.inflow((speed, 0.0, 0.0))
        bcs[(0, 1)] = BCSpec(BCKind.CONVECTIVE, (conv_speed_entry,))
        return bcs

    sim_td = Simulation.build(g, bcs_with(lambda t: speed + 0.0 * t), params)
    assert sim_td._time_dependent()
    out_td, _ = sim_td.run_scan(sim_td.initial_state(), 4)

    sim_st = Simulation.build(g, bcs_with(speed), params)
    out_st, _ = sim_st.run_scan(sim_st.initial_state(), 4)
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(out_td.u[c]), np.asarray(out_st.u[c]), atol=1e-6
        )


def test_timedep_run_scan_zero_steps():
    """n_steps=0 on a time-dependent run returns the initial state and an
    empty diagnostics stack."""
    grid = GridSpec(shape=(16, 16, 16), lengths=(1.0, 1.0, 1.0))
    bcs = no_slip_box(grid)
    bcs[(0, 1)] = BCSpec.wall((0.0, lambda t: jnp.cos(t), 0.0))
    params = SimParams(
        dt=2e-3, nu=0.01,
        poisson=PoissonConfig(method="cg", tol=1e-6, max_iters=200),
    )
    sim = Simulation.build(grid, bcs, params)
    st0 = sim.initial_state()
    out, diags = sim.run_scan(st0, 0)
    for c in range(3):
        np.testing.assert_allclose(
            np.asarray(out.u[c]), np.asarray(st0.u[c]), atol=0.0
        )
    assert np.asarray(diags.dt).shape[0] == 0


def test_oscillating_lid_case_registry():
    """The oscillating_lid registry case drives a Stokes-layer flow: one
    scan, t advances, fields finite, and the near-lid tangential flow
    reverses between the lid's extremes (cos(omega t) = +1 vs -1)."""
    from navierstokessolver_tpu.cases import make_case

    case = make_case("oscillating_lid", shape=(16, 16, 16), re=50.0,
                     poisson_method="cg", dt=2.5e-3)
    sim = case.sim
    dt = sim.params.dt
    half_period = 0.5  # omega = 2 pi -> period 1.0
    n_half = int(round(half_period / dt))
    st, d = sim.run_scan(case.initial_state(), n_half)
    u0 = np.asarray(st.u[0])     # lid slides in +x = comp 0; lid at axis-2 HI
    near_lid_1 = u0[:, :, -1].mean()
    st2, _ = sim.run_scan(st, n_half)
    near_lid_2 = np.asarray(st2.u[0])[:, :, -1].mean()
    assert np.isfinite(near_lid_1) and np.isfinite(near_lid_2)
    # at t = half period the lid is at -1, at t = period back at +1; the
    # near-lid cell follows within the thin Stokes layer
    assert near_lid_1 < 0.0 < near_lid_2
    np.testing.assert_allclose(float(st2.t), 2 * n_half * dt, rtol=1e-5)
    assert float(np.asarray(d.max_div)[-1]) < 1e-3
