"""CI-light physics oracles (VERDICT r1 item 10): the PARITY.md claims from
scripts/ghia_validation.py and scripts/strouhal.py, continuously verified as
``@pytest.mark.slow`` tests (excluded from the default quick suite by
pytest.ini; run with ``python -m pytest tests/ -m slow -q``).

Oracles are public literature values: Ghia, Ghia & Shin (1982) cavity
centerline extrema; Williamson (1989) cylinder Strouhal number. Grids are
deliberately small, so the tolerances are discretization-limited, not
solver-limited; the full-resolution numbers live in docs/PARITY.md.
"""

import numpy as np
import pytest

from navierstokessolver_tpu import interpolate_to_centers
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.solver import steady_state_delta

pytestmark = pytest.mark.slow


def _run_to_steady(sim, state, t_end, chunk=500, tol=1e-5):
    dt = sim.params.dt
    steps = 0
    while steps * dt < t_end:
        prev = state
        state, _ = sim.run_scan(state, chunk)
        steps += chunk
        if steady_state_delta(prev, state, dt * chunk) < tol:
            break
    return state


def test_ghia_re1000_centerlines():
    """Re=1000 cavity at 128^2: centerline extrema vs Ghia et al. table.

    At 128^2 with gamma=0.25 donor-cell blending the discretization error
    dominates (measured: u_min 7.7%, v_max 8.3%, v_min 4.2%); 12% relative
    tolerance brackets it (full-resolution run in docs/PARITY.md: 256^2
    within ~2%)."""
    case = make_case("cavity", shape=(128, 128), re=1000.0, upwind_gamma=0.25)
    sim = case.sim
    state = _run_to_steady(sim, case.initial_state(), t_end=50.0)
    uc, vc = interpolate_to_centers(sim.grid, state.u)
    n = sim.grid.shape[0]
    u_min = float(np.asarray(uc)[n // 2, :].min())
    v_line = np.asarray(vc)[:, n // 2]
    assert abs(u_min - (-0.38289)) / 0.38289 < 0.12, u_min
    assert abs(float(v_line.max()) - 0.37095) / 0.37095 < 0.12, v_line.max()
    assert abs(float(v_line.min()) - (-0.51550)) / 0.51550 < 0.12, v_line.min()


def test_strouhal_smoke():
    """Small-grid (192x96) Re=200 cylinder: vortex shedding onsets and the
    Strouhal number lands in a loose literature bracket (0.15-0.25; the
    512x256 production run in docs/PARITY.md hits ~0.19-0.20)."""
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state

    case = make_case(
        "cylinder", shape=(192, 96), re=200.0, poisson_method="mg"
    )
    sim = case.sim
    g = sim.grid
    dt = sim.params.dt
    chunk = 25
    t_end = 90.0
    ix = int((4.0 + 2.5) / g.lengths[0] * g.shape[0])
    iy = g.shape[1] // 2

    state = impulsive_start_state(sim)
    series = []
    done = 0
    n_steps = int(t_end / dt)
    while done + chunk <= n_steps:
        state, _ = sim.run_scan(state, chunk)
        series.append(float(state.u[1][ix, iy]))
        done += chunk

    sig = np.asarray(series[len(series) // 2:], dtype=np.float64)
    sig -= sig.mean()
    assert sig.max() - sig.min() > 0.05, "no shedding developed"
    freqs = np.fft.rfftfreq(len(sig), d=chunk * dt)
    amp = np.abs(np.fft.rfft(sig))
    st = float(freqs[np.argmax(amp[1:]) + 1])  # D = U = 1
    assert 0.15 < st < 0.25, st


def test_uniform_flow_zero_force():
    """CV sanity (fast): a body-free box in steady uniform flow carries no
    net force (flux/pressure surface terms cancel)."""
    import jax.numpy as jnp

    from navierstokessolver_tpu import GridSpec
    from navierstokessolver_tpu.grid import State
    from navierstokessolver_tpu.utils.forces import cv_terms

    g = GridSpec(shape=(32, 32), lengths=(1.0, 1.0))
    u = jnp.ones(g.face_shape(0))
    v = jnp.zeros(g.face_shape(1))
    p = jnp.full(g.shape, 0.3)
    sfx, sfy, mx, my = cv_terms(
        g, State(u=(u, v), p=p), 0.01, (8, 24, 8, 24)
    )
    assert abs(float(sfx)) < 1e-5 and abs(float(sfy)) < 1e-5
    assert abs(float(mx) - 0.25) < 1e-5  # 0.5x0.5 box of unit u


def test_cylinder_drag_coefficient():
    """Mean drag at Re=200 on a small grid lands in the literature bracket
    (Cd ~ 1.3-1.4 at production resolution; loose bracket here)."""
    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state
    from navierstokessolver_tpu.utils.forces import cv_terms, drag_lift_series

    case = make_case("cylinder", shape=(192, 96), re=200.0,
                     poisson_method="mg")
    sim = case.sim
    g = sim.grid
    dt = sim.params.dt
    hx, hy = g.spacing
    box = (int(2.5 / hx), int(5.5 / hx), int(2.5 / hy), int(5.5 / hy))
    state = impulsive_start_state(sim)
    chunk = 25
    sfx, sfy, mx, my = [], [], [], []
    n_steps = int(90.0 / dt)
    done = 0
    while done + chunk <= n_steps:
        state, _ = sim.run_scan(state, chunk)
        a, b, c, d = cv_terms(g, state, sim.params.nu, box)
        sfx.append(float(a)); sfy.append(float(b))
        mx.append(float(c)); my.append(float(d))
        done += chunk
    cd, cl = drag_lift_series(g, sim.params.nu, box, sfx, sfy, mx, my,
                              chunk * dt)
    half = len(cd) // 2
    cd_mean = float(np.mean(cd[half:]))
    cl_amp = float((cl[half:].max() - cl[half:].min()) / 2)
    assert 1.0 < cd_mean < 1.8, cd_mean
    assert cl_amp > 0.2, cl_amp  # shedding-driven lift oscillation


def test_taylor_green3d_dissipation_history():
    """3D TGV vortex stretching (Brachet et al. 1983): kinetic energy decays
    monotonically and the dissipation rate -dE/dt RISES as vortex stretching
    builds small scales (its peak sits near t~5-9 at high Re; at Re=400 on
    64^3 we assert the qualitative signature: mid-time dissipation exceeds
    the initial dissipation)."""
    import jax.numpy as jnp

    from navierstokessolver_tpu.cases import make_case

    case = make_case("taylor_green3d", shape=(64, 64, 64), re=400.0)
    sim = case.sim
    g = sim.grid
    dt = sim.params.dt
    vol = 1.0
    for h in g.spacing:
        vol *= h

    def energy(st):
        return float(sum(
            0.5 * vol * float(jnp.sum(c * c)) for c in st.u
        ))

    st = case.initial_state()
    t_samples, e_samples = [0.0], [energy(st)]
    chunk = max(1, int(round(0.5 / dt)))
    for k in range(16):  # to t = 8
        st, d = sim.run_scan(st, chunk)
        t_samples.append((k + 1) * chunk * dt)
        e_samples.append(energy(st))
        assert float(d.max_div[-1]) < 1e-4
    e = np.asarray(e_samples)
    assert (np.diff(e) < 0).all(), "energy must decay monotonically"
    diss = -np.gradient(e, np.asarray(t_samples))
    # vortex stretching: dissipation grows well above its initial value
    assert diss[8:].max() > 1.5 * diss[1], (diss[1], diss[8:].max())



def _steady_cylinder_cd(nx, ny, sharp):
    """Steady Re=40 cylinder drag via the control-volume balance."""
    import numpy as np

    from navierstokessolver_tpu.cases.cylinder import impulsive_start_state
    from navierstokessolver_tpu.utils.forces import drag_lift_series

    case = make_case(
        "cylinder", shape=(nx, ny), re=40.0, poisson_method="mg",
        poisson_tol=1e-6, ibm=True, sharp_pressure=sharp,
        poisson_extrapolate=0.0,
    )
    sim = case.sim
    g = sim.grid
    dt = sim.params.dt
    hx, hy = g.spacing
    box = (int(2.5 / hx), int(5.5 / hx), int(2.5 / hy), int(5.5 / hy))
    st = impulsive_start_state(sim)
    n = int(50.0 / dt)
    chunk = 500
    sfs, moms = [], []
    done = 0
    while done < n:
        st, _, sf, mom = sim.run_scan_forces(st, chunk, box)
        sfs.append(np.asarray(sf))
        moms.append(np.asarray(mom))
        done += chunk
    sf = np.concatenate(sfs)
    mom = np.concatenate(moms)
    cd, _ = drag_lift_series(
        g, sim.params.nu, box, sf[:, 0], sf[:, 1], mom[:, 0], mom[:, 1], dt
    )
    return float(np.mean(cd[-200:]))   # steady tail


def test_cut_cell_cd_self_convergence():
    """Both-sides-sharp (IBM velocity + cut-cell pressure) steady Re=40
    drag self-converges under refinement and lands in the confined-
    cylinder bracket. CI-light companion of the full Re=200
    sharp-vs-staircase convergence study (256x128 within 1% of 512x256).
    (A short
    Re=40 run still carries impulsive-start transient at coarse grids --
    6 cells/D -- so this asserts self-consistency, not superiority.)"""
    cd_sharp_c = _steady_cylinder_cd(128, 64, True)
    cd_sharp_f = _steady_cylinder_cd(192, 96, True)
    # confined (12.5% blockage) steady Re=40: literature unbounded ~1.5,
    # blockage raises it; transient tail at t=50 adds a few percent
    for cd in (cd_sharp_c, cd_sharp_f):
        assert 1.4 < cd < 2.4, (cd_sharp_c, cd_sharp_f)
    assert abs(cd_sharp_c - cd_sharp_f) < 0.12 * cd_sharp_f, \
        (cd_sharp_c, cd_sharp_f)


def test_heated_cylinder_nusselt():
    """Forced convection from an isothermal cylinder at Re=20, Pr=0.7
    (steady twin-vortex regime): mean Nusselt number vs the
    Churchill-Bernstein correlation (~2.46; Dennis, Hudson & Smith 1968
    numerical: ~2.41). The staircase interface at 16 cells/diameter and
    the 12.5% lateral blockage bound the accuracy, so the bracket is
    generous; the number must land in the physically right regime (an
    unheated answer would be 0, a conduction-only answer ~1)."""
    case = make_case("heated_cylinder", shape=(256, 128), re=20.0,
                     poisson_method="mg")
    sim = case.sim
    st = _run_to_steady(sim, sim.initial_state(), t_end=60.0)
    from navierstokessolver_tpu.scalar import body_heat_flux

    q = float(body_heat_flux(sim.grid, sim.scalar, st.theta,
                             sim.scalar_solid))
    alpha = sim.scalar.diffusivity
    nu_mean = q / (np.pi * alpha)      # D = 1, dT = 1
    assert 1.9 < nu_mean < 3.2, nu_mean
    # the thermal wake is downstream and bounded
    th = np.asarray(st.theta)
    assert th.max() <= 1.001 and th.min() >= -0.01
    x_c = int(4.0 / 16.0 * 256)        # cylinder center column
    assert th[x_c + 40, 64] > th[x_c - 40, 64]  # wake hotter than upstream
