"""2D decaying turbulence + spectral diagnostics.

Oracles: the streamfunction-curl IC is discretely divergence-free to
roundoff BEFORE any projection; Parseval ties the radial spectrum to the
total kinetic energy; viscous decay is monotone; and the classic 2D
phenomenology holds -- the energy centroid moves to LARGER scales (inverse
cascade) while enstrophy decays selectively."""

import numpy as np
import jax.numpy as jnp

from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.ops.stencils import divergence
from navierstokessolver_tpu.utils.spectra import (
    energy_spectrum_2d,
    total_kinetic_energy,
)


def test_ic_exactly_divergence_free_and_parseval():
    case = make_case("decaying_turbulence", shape=(64, 64), seed=3)
    st = case.initial_state()
    div = np.asarray(divergence(case.sim.grid, st.u))
    assert np.abs(div).max() < 1e-4   # roundoff at f32 with 1/h scaling
    k, E = energy_spectrum_2d(case.sim.grid, st.u)
    ke = total_kinetic_energy(case.sim.grid, st.u)
    np.testing.assert_allclose(E.sum(), ke, rtol=2e-2)
    # band-limited around k0=6
    assert k[np.argmax(E)] <= 12
    # center-interpolated energy sits ~1% under the face normalization
    np.testing.assert_allclose(ke, 0.5, rtol=2.5e-2)   # u_rms = 1


def test_decay_and_inverse_cascade():
    case = make_case("decaying_turbulence", shape=(128, 128), re=2000.0,
                     k0=12.0, seed=1)
    sim = case.sim
    st = case.initial_state()
    k, E0 = energy_spectrum_2d(sim.grid, st.u)
    ke0 = total_kinetic_energy(sim.grid, st.u)
    c0 = float((k * E0).sum() / E0.sum())     # energy-centroid wavenumber

    n = int(round(4.0 / sim.params.dt))
    st, d = sim.run_scan(st, n)
    assert float(d.max_div[-1]) < 1e-4
    ke1 = total_kinetic_energy(sim.grid, st.u)
    _, E1 = energy_spectrum_2d(sim.grid, st.u)
    c1 = float((k * E1).sum() / E1.sum())

    assert ke1 < ke0                            # viscous decay
    assert ke1 > 0.3 * ke0                      # ...but 2D decays slowly
    assert c1 < 0.9 * c0, (c0, c1)              # inverse cascade: centroid down


def test_energy_spectrum_3d_single_mode_and_parseval():
    """A single-wavenumber 3D field puts (almost) all its energy in that
    shell, and shell sums reproduce the total KE (Parseval)."""
    import jax.numpy as jnp
    import numpy as np

    from navierstokessolver_tpu.grid import GridSpec
    from navierstokessolver_tpu.utils.spectra import (
        energy_spectrum_3d,
        total_kinetic_energy,
    )

    g = GridSpec(shape=(32, 32, 32), lengths=(2 * np.pi,) * 3)

    def face_mesh(a):
        axes = [
            (jnp.arange(g.shape[c] + (1 if c == a else 0))
             + (0.0 if c == a else 0.5)) * g.spacing[c]
            for c in range(3)
        ]
        return jnp.meshgrid(*axes, indexing="ij")

    xu, yu, _ = face_mesh(0)
    xv, yv, _ = face_mesh(1)
    zw = face_mesh(2)[2]
    # Taylor-Green-like k=2 mode, divergence-free, w = 0
    km = 2.0
    u = (jnp.sin(km * xu) * jnp.cos(km * yu),
         -jnp.cos(km * xv) * jnp.sin(km * yv),
         jnp.zeros_like(zw))
    k, E = energy_spectrum_3d(g, u)
    peak_shell = int(k[np.argmax(E)])
    # |k| = sqrt(2^2 + 2^2) ~ 2.83 -> shell 3
    assert peak_shell == 3, (peak_shell, E[:6])
    assert E.max() / E.sum() > 0.99
    np.testing.assert_allclose(E.sum(), total_kinetic_energy(g, u),
                               rtol=1e-3)


def test_kolmogorov_laminar_balance_2d():
    """Low-Re Kolmogorov flow relaxes to the exact laminar profile
    u = A/(nu k^2) sin(k y) (the spatially-varying-forcing oracle)."""
    case = make_case("kolmogorov", shape=(32, 32), re=1.0, k_forcing=2)
    sim = case.sim
    nu, kf, amp = sim.params.nu, 2, 1.0
    st = case.initial_state()
    # many viscous times of the forcing scale: e^-8 of the transient left
    n = int(8.0 / (nu * kf * kf) / sim.params.dt)
    st, diag = sim.run_scan(st, n)
    yc = np.asarray(sim.grid.cell_centers(1))
    # steady amplitude of the DISCRETE operator: A / (nu * lap_h-eigenvalue
    # of sin(k y)); the continuum A/(nu k^2) differs by (kh)^2/12 ~ 1.3%
    h = sim.grid.spacing[1]
    lam_h = (2.0 - 2.0 * np.cos(kf * h)) / (h * h)
    u_disc = amp / (nu * lam_h)
    exact = u_disc * np.sin(kf * yc)
    u = np.asarray(st.u[0])[: sim.grid.shape[0], :]
    err = np.max(np.abs(u - exact[None, :])) / u_disc
    assert err < 2e-3, err
    # ... and the continuum profile to its second-order error
    u_lam = amp / (nu * kf * kf)
    err_c = np.max(np.abs(u - (u_lam * np.sin(kf * yc))[None, :])) / u_lam
    assert err_c < 0.02, err_c
    assert np.isfinite(float(diag.max_div[-1]))
