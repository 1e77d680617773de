"""Smagorinsky LES closure (les.py).

Validation ladder:
  * pure shear: nu_t == (Cs Delta)^2 |du/dy| exactly, SGS force == 0
    (constant stress has zero divergence);
  * constant-nu_t consistency: on a discretely divergence-free field the
    stress divergence equals nu_t * laplacian EXACTLY (discrete differences
    commute), verified against ops/stencils.laplacian_component on periodic
    (2D + 3D) and wall-bounded boxes -- this pins every line of the
    staggered-tensor bookkeeping;
  * physics: the model only ever adds dissipation (KE decays faster than
    the unmodeled run on decaying turbulence).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu import GridSpec
from navierstokessolver_tpu.bcs import BCSpec
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.les import LESConfig, eddy_viscosity, sgs_forcing
from navierstokessolver_tpu.ops import stencils


def _periodic_bcs(nd):
    return {(a, s): BCSpec.periodic() for a in range(nd) for s in (0, 1)}


def _wall_bcs(nd):
    return {(a, s): BCSpec.wall(tuple([0.0] * nd))
            for a in range(nd) for s in (0, 1)}


def test_pure_shear_eddy_viscosity_and_zero_force():
    # Couette setup: u = gamma * y, v = 0, moving lid at y=1 so the wall
    # reflection ghosts represent the linear profile exactly; |S| = gamma
    # everywhere and the constant stress has zero divergence.
    n = 16
    g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
    bcs = _wall_bcs(2)
    bcs[(1, 1)] = BCSpec.wall((3.0, 0.0))  # lid speed = gamma * L_y
    gamma = 3.0
    dy = g.spacing[1]
    yc = (np.arange(n) + 0.5) * dy
    u0 = jnp.asarray(np.broadcast_to(gamma * yc, (n + 1, n)), jnp.float32)
    u1 = jnp.zeros((n, n + 1), jnp.float32)
    cfg = LESConfig(cs=0.17)
    nu_t = eddy_viscosity(g, bcs, (u0, u1), cfg)
    expect = (0.17 * cfg.filter_width(g)) ** 2 * gamma
    np.testing.assert_allclose(np.asarray(nu_t), expect, rtol=1e-5)
    f = sgs_forcing(g, bcs, (u0, u1), cfg)
    assert f[0].shape == (n - 1, n)
    assert f[1].shape == (n, n - 1)
    for comp in f:
        np.testing.assert_allclose(np.asarray(comp), 0.0, atol=1e-4)


def _taylor_green_mac(n):
    """Sampled TG field on the MAC grid with duplicate wrap faces; exactly
    divergence-free in the MAC sense when dx == dy."""
    L = 2.0 * math.pi
    g = GridSpec(shape=(n, n), lengths=(L, L))
    dx, dy = g.spacing
    xf = np.arange(n + 1) * dx
    yc = (np.arange(n) + 0.5) * dy
    xc = (np.arange(n) + 0.5) * dx
    yf = np.arange(n + 1) * dy
    u0 = np.sin(xf)[:, None] * np.cos(yc)[None, :]
    u1 = -np.cos(xc)[:, None] * np.sin(yf)[None, :]
    return g, (jnp.asarray(u0, jnp.float32), jnp.asarray(u1, jnp.float32))


def test_constant_nut_matches_laplacian_periodic_2d():
    n = 32
    g, u = _taylor_green_mac(n)
    bcs = _periodic_bcs(2)
    div = np.asarray(stencils.divergence(g, u))
    assert np.abs(div).max() < 1e-6  # exactly div-free (roundoff)
    c = 0.37
    nu_t = jnp.full(g.shape, c, jnp.float32)
    f = sgs_forcing(g, bcs, u, LESConfig(), nu_t=nu_t)
    for a in range(2):
        lap = np.asarray(stencils.laplacian_component(g, bcs, a, u[a]))
        np.testing.assert_allclose(np.asarray(f[a]), c * lap, atol=3e-5)


def test_constant_nut_matches_laplacian_walls_2d():
    # Streamfunction-derived field in a wall box (exactly div-free,
    # near-zero at the walls so the reflection ghosts are consistent).
    n = 24
    g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
    bcs = _wall_bcs(2)
    dx, dy = g.spacing
    xn = np.arange(n + 1) * dx
    yn = np.arange(n + 1) * dy
    psi = (np.sin(np.pi * xn) ** 2)[:, None] * (np.sin(np.pi * yn) ** 2)[None, :]
    u0 = (psi[:, 1:] - psi[:, :-1]) / dy           # (n+1, n)
    u1 = -(psi[1:, :] - psi[:-1, :]) / dx          # (n, n+1)
    u = (jnp.asarray(u0, jnp.float32), jnp.asarray(u1, jnp.float32))
    assert np.abs(np.asarray(stencils.divergence(g, u))).max() < 1e-5
    c = 0.21
    nu_t = jnp.full(g.shape, c, jnp.float32)
    f = sgs_forcing(g, bcs, u, LESConfig(), nu_t=nu_t)
    for a in range(2):
        lap = np.asarray(stencils.laplacian_component(g, bcs, a, u[a]))
        np.testing.assert_allclose(np.asarray(f[a]), c * lap, atol=5e-4)


def test_constant_nut_matches_laplacian_periodic_3d():
    n = 12
    L = 2.0 * math.pi
    g = GridSpec(shape=(n, n, n), lengths=(L, L, L))
    bcs = _periodic_bcs(3)
    dx, dy, dz = g.spacing
    xf = np.arange(n + 1) * dx
    xc = (np.arange(n) + 0.5) * dx
    yf = np.arange(n + 1) * dy
    yc = (np.arange(n) + 0.5) * dy
    zc = (np.arange(n) + 0.5) * dz
    # TG3D: u = sin x cos y cos z, v = -cos x sin y cos z, w = 0;
    # dx == dy makes the sampled field exactly MAC-divergence-free.
    u0 = np.sin(xf)[:, None, None] * np.cos(yc)[None, :, None] \
        * np.cos(zc)[None, None, :]
    u1 = -np.cos(xc)[:, None, None] * np.sin(yf)[None, :, None] \
        * np.cos(zc)[None, None, :]
    u2 = np.zeros((n, n, n + 1))
    u = tuple(jnp.asarray(x, jnp.float32) for x in (u0, u1, u2))
    assert np.abs(np.asarray(stencils.divergence(g, u))).max() < 1e-6
    c = 0.11
    nu_t = jnp.full(g.shape, c, jnp.float32)
    f = sgs_forcing(g, bcs, u, LESConfig(), nu_t=nu_t)
    for a in range(3):
        lap = np.asarray(stencils.laplacian_component(g, bcs, a, u[a]))
        np.testing.assert_allclose(np.asarray(f[a]), c * lap, atol=3e-5)


def _kinetic_energy(u):
    return sum(float((np.asarray(c, np.float64) ** 2).sum()) for c in u)


def test_les_adds_dissipation_on_turbulence():
    base = make_case("decaying_turbulence", shape=(64, 64), re=20_000.0,
                     seed=3)
    les = make_case("decaying_turbulence", shape=(64, 64), re=20_000.0,
                    seed=3, les_cs=0.2)
    assert les.sim.les is not None and les.sim.les.cs == 0.2
    n = 40
    s0, _ = base.sim.run_scan(base.initial_state(), n)
    s1, _ = les.sim.run_scan(les.initial_state(), n)
    e0, e1 = _kinetic_energy(s0.u), _kinetic_energy(s1.u)
    assert np.isfinite(e1) and e1 > 0.0
    assert e1 < e0  # the closure only ever dissipates


def test_les_gates_fused_paths_and_hashes():
    import dataclasses

    from navierstokessolver_tpu import io as io_mod

    case = make_case("cavity", shape=(32, 32))
    sim = dataclasses.replace(case.sim, les=LESConfig(cs=0.17))
    h0 = io_mod.config_hash(sim.grid, sim.params)
    h1 = io_mod.config_hash(sim.grid, sim.params, les=sim.les)
    assert h0 != h1
    # and the LES step itself runs (jnp path) and stays finite
    out, diag = sim.run_scan(sim.initial_state(), 3)
    assert np.isfinite(float(diag.max_div[-1]))


def test_test_filter_preserves_constants_and_wraps():
    from navierstokessolver_tpu.les import test_filter

    g = GridSpec(shape=(16, 16), lengths=(1.0, 1.0))
    const = jnp.full(g.shape, 3.25, jnp.float32)
    for bcs in (_wall_bcs(2), _periodic_bcs(2)):
        out = np.asarray(test_filter(g, bcs, const))
        np.testing.assert_allclose(out, 3.25, atol=1e-6)
    # periodic: filtering a pure Fourier mode scales it by the kernel's
    # transfer function per axis, cos^2(k h / 2) for [1/4, 1/2, 1/4]
    bcs = _periodic_bcs(2)
    k = 3
    x = (np.arange(16) + 0.5) / 16.0
    f = np.cos(2 * np.pi * k * x)[:, None] * np.ones((1, 16))
    out = np.asarray(test_filter(g, bcs, jnp.asarray(f, jnp.float32)))
    gain = np.cos(np.pi * k / 16.0) ** 2
    np.testing.assert_allclose(out, gain * f, atol=1e-5)


def test_dynamic_cs2_self_quenches_on_resolved_field():
    # A single-mode Taylor-Green field is fully resolved at 64^2: the
    # Germano identity is satisfied with a tiny coefficient, so the
    # dynamic model must return (near-)zero -- no spurious dissipation on
    # laminar flows, which is the whole point of the dynamic procedure.
    from navierstokessolver_tpu.les import dynamic_cs2

    n = 64
    g, u = _taylor_green_mac(n)
    bcs = _periodic_bcs(2)
    cs2 = float(dynamic_cs2(g, bcs, u, LESConfig(model="dynamic")))
    assert 0.0 <= cs2 < 0.17 ** 2 / 4.0, cs2


def test_dynamic_cs2_activates_on_rough_3d_field():
    # In 3D, a broadband random field forward-scatters energy to the
    # subgrid scales, so the Germano numerator <L:M> is positive and the
    # coefficient activates.
    from navierstokessolver_tpu.les import (
        dynamic_cs2,
        eddy_viscosity,
        test_filter,
    )

    n = 24
    g = GridSpec(shape=(n, n, n), lengths=(1.0, 1.0, 1.0))
    bcs = _periodic_bcs(3)
    rng = np.random.default_rng(0)
    u = []
    for a in range(3):
        f = rng.normal(size=g.shape).astype(np.float32)
        f = np.asarray(test_filter(g, bcs, jnp.asarray(f)))  # de-checkerboard
        dup = [slice(None)] * 3
        dup[a] = slice(0, 1)
        arr = np.concatenate([f, f[tuple(dup)]], axis=a)  # wrap face
        u.append(jnp.asarray(arr))
    cfg = LESConfig(model="dynamic")
    cs2 = float(dynamic_cs2(g, bcs, tuple(u), cfg))
    assert 0.0 < cs2 <= cfg.cs2_max, cs2
    nu_t = np.asarray(eddy_viscosity(g, bcs, tuple(u), cfg))
    assert np.isfinite(nu_t).all() and (nu_t >= 0).all() and nu_t.max() > 0


def test_dynamic_cs2_self_quenches_in_2d_inverse_cascade():
    # 2D turbulence transfers energy UPSCALE (net backscatter), so the
    # Germano numerator comes out (slightly) negative on a developed 2D
    # field and the clipped dynamic coefficient is zero -- the model
    # correctly refuses to add forward-scatter dissipation in 2D.
    from navierstokessolver_tpu.les import dynamic_cs2

    case = make_case("decaying_turbulence", shape=(64, 64), re=50_000.0,
                     k0=12.0, seed=9)
    st = case.initial_state()
    g, bcs = case.sim.grid, case.sim.bcs
    cs2 = float(dynamic_cs2(g, bcs, st.u, LESConfig(model="dynamic")))
    assert cs2 == 0.0, cs2


def test_dynamic_les_dissipates_and_runs():
    base = make_case("decaying_turbulence", shape=(48, 48), re=20_000.0,
                     seed=4)
    dyn = make_case("decaying_turbulence", shape=(48, 48), re=20_000.0,
                    seed=4, les_model="dynamic")
    assert dyn.sim.les is not None and dyn.sim.les.model == "dynamic"
    n = 30
    s0, _ = base.sim.run_scan(base.initial_state(), n)
    s1, d1 = dyn.sim.run_scan(dyn.initial_state(), n)
    e0, e1 = _kinetic_energy(s0.u), _kinetic_energy(s1.u)
    assert np.isfinite(e1) and 0.0 < e1 <= e0 * (1.0 + 1e-6)
