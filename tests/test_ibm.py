"""Sharp-interface immersed boundary (ibm.py): build invariants, linear
exactness, a Couette oracle against the staircase treatment, and the
solver integration."""

import jax.numpy as jnp
import numpy as np

from navierstokessolver_tpu import ibm as ibm_mod
from navierstokessolver_tpu.bcs import (
    BCSpec,
    face_masks_from_solid,
    no_slip_box,
)
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops.poisson import PoissonConfig
from navierstokessolver_tpu.solver import SimParams, Simulation


def _circle_setup(n=32, r=0.2):
    g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    sdf = lambda x, y: np.hypot(x - 0.5, y - 0.5) - r  # noqa: E731
    solid = ibm_mod.solid_from_sdf(g, sdf)
    fm = face_masks_from_solid(g, solid)
    return g, bcs, sdf, solid, fm


def test_build_invariants_circle():
    g, bcs, sdf, solid, fm = _circle_setup()
    op = ibm_mod.build_ibm(g, bcs, sdf, fm)
    assert op is not None
    for a in range(2):
        band = np.asarray(op.band[a])
        masks = [np.asarray(m) for m in op.masks[a]]
        total = sum(masks)
        # one-hot: each band face has exactly one neighbor direction
        np.testing.assert_array_equal(total, band)
        assert total.max() <= 1.0
        # band faces are open (staircase mask 1) and weights are in [0, 1)
        open_f = np.asarray(fm[a]) > 0.5
        assert np.all(open_f[band > 0])
        w = np.asarray(op.w[a])
        assert np.all(w[band > 0] >= 0.0)
        assert np.all(w[band > 0] < 1.0)
        assert band.sum() > 0


def test_empty_band_returns_none():
    g = GridSpec(shape=(16, 16), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    sdf = lambda x, y: np.hypot(x - 5.0, y - 5.0) - 0.2  # far outside  # noqa: E731
    solid = ibm_mod.solid_from_sdf(g, sdf)
    assert not solid.any()
    fm = face_masks_from_solid(g, np.zeros(g.shape, bool))
    assert ibm_mod.build_ibm(g, bcs, sdf, fm) is None


def test_linear_profile_exactness_plane_wall():
    """Linear interpolation reproduces a linear profile vanishing at the
    immersed plane exactly (the second-order consistency check)."""
    g = GridSpec(shape=(16, 16), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    y0 = 0.37
    sdf = lambda x, y: y - y0  # solid below the plane  # noqa: E731
    solid = ibm_mod.solid_from_sdf(g, sdf)
    fm = face_masks_from_solid(g, solid)
    op = ibm_mod.build_ibm(g, bcs, sdf, fm)
    yc = (np.arange(16) + 0.5) / 16.0
    u = jnp.asarray(np.broadcast_to((yc - y0)[None, :], (17, 16))
                    .astype(np.float32))
    yf = np.arange(17) / 16.0
    v = jnp.asarray(np.broadcast_to((yf - y0)[None, :], (16, 17))
                    .astype(np.float32))
    uf, vf = op.apply((u, v))
    for comp, got, band in ((u, uf, op.band[0]), (v, vf, op.band[1])):
        err = jnp.max(jnp.abs(jnp.where(band > 0, got - comp, 0.0)))
        assert float(err) < 1e-6
        # off-band faces pass through untouched
        same = jnp.where(band > 0, 0.0, got - comp)
        assert float(jnp.max(jnp.abs(same))) == 0.0


def test_sphere_build_3d():
    g = GridSpec(shape=(16, 16, 16), lengths=(1.0, 1.0, 1.0))
    bcs = no_slip_box(g)
    sdf = lambda x, y, z: np.sqrt(  # noqa: E731
        (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - 0.22
    solid = ibm_mod.solid_from_sdf(g, sdf)
    fm = face_masks_from_solid(g, solid)
    op = ibm_mod.build_ibm(g, bcs, sdf, fm)
    assert op is not None and op.ndim == 3
    for a in range(3):
        band = np.asarray(op.band[a])
        assert band.sum() > 0
        np.testing.assert_array_equal(
            sum(np.asarray(m) for m in op.masks[a]), band
        )


def test_cylinder_case_ibm_runs():
    case = make_case("cylinder", shape=(96, 48), lengths=(8.0, 4.0),
                     center=(2.0, 2.003), poisson_method="mg", ibm=True)
    sim = case.sim
    assert sim.ibm is not None
    st, diag = sim.run_scan(case.initial_state(), 30)
    assert np.isfinite(float(diag.max_div[-1]))
    assert float(diag.max_div[-1]) < 1e-3
    # the forcing leaves a nonzero band signature: interpolated (non-zero)
    # velocities on first-ring faces that the staircase treatment would
    # evolve freely
    assert float(jnp.max(sim.ibm.band[0])) == 1.0


def test_ibm_couette_beats_staircase():
    """Couette flow over an immersed plane wall at y0 (off-lattice): the
    steady profile is linear between y0 and the moving lid. Direct forcing
    must place the zero crossing at y0 to ~h^2; the staircase places it at
    the nearest face (O(h)). Compare centerline errors after the same run."""
    n = 24
    y0 = 0.23 * (1.0 - 1e-3) + 0.5 / n * 1e-3  # generic, off-lattice
    lid = 1.0

    def run(use_ibm):
        g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
        bcs = no_slip_box(g)
        bcs[(0, 0)] = BCSpec.periodic()  # planar Couette: no side walls
        bcs[(0, 1)] = BCSpec.periodic()
        bcs[(1, 1)] = BCSpec.wall((lid, 0.0))
        sdf = lambda x, y: y - y0  # noqa: E731
        solid = ibm_mod.solid_from_sdf(g, sdf)
        nu = 0.1
        params = SimParams(
            dt=2e-3, nu=nu,
            poisson=PoissonConfig(method="cg", tol=1e-7, max_iters=500),
        )
        sim = Simulation.build(g, bcs, params, solid=solid,
                               sdf=sdf if use_ibm else None)
        st = sim.initial_state()
        st, _ = sim.run_scan(st, 6000)  # t=12 >> L^2/nu
        # u at mid-x column, cell-centered in y
        u = np.asarray(st.u[0])[n // 2, :]
        return g, u

    g, u_ibm = run(True)
    _, u_stair = run(False)
    yc = np.asarray(g.cell_centers(1))
    fluid = yc > y0 + 1.5 / n  # compare clear of the immediate band
    exact = lid * (yc - y0) / (1.0 - y0)
    err_ibm = np.max(np.abs(u_ibm[fluid] - exact[fluid]))
    err_stair = np.max(np.abs(u_stair[fluid] - exact[fluid]))
    assert err_ibm < 0.5 * err_stair, (err_ibm, err_stair)
    assert err_ibm < 0.02 * lid


def test_config_hash_includes_ibm():
    from navierstokessolver_tpu import io as io_mod

    case = make_case("cavity", shape=(16, 16))
    h0 = io_mod.config_hash(case.sim.grid, case.sim.params)
    h1 = io_mod.config_hash(case.sim.grid, case.sim.params, ibm=True)
    assert h0 != h1


def test_taylor_couette_annulus_exact():
    """Moving-boundary IBM: the annulus between a rotating inner cylinder
    (immersed, omega=1) and a stationary outer cylinder (immersed) has the
    exact steady solution u_theta(r) = A r + B/r -- an exact Navier-Stokes
    solution at ANY Reynolds number, so the only error is the boundary
    treatment + spatial discretization."""
    n = 64
    g = GridSpec(shape=(n, n), lengths=(1.0, 1.0))
    bcs = no_slip_box(g)
    c = (0.5, 0.5)
    r1, r2 = 0.15, 0.40
    omega = 1.0

    def sdf(x, y):
        r = np.hypot(x - c[0], y - c[1])
        return np.minimum(r - r1, r2 - r)  # fluid: the annulus

    def vel(x, y):
        r = np.hypot(x - c[0], y - c[1])
        inner = r < 0.5 * (r1 + r2)
        return (np.where(inner, -omega * (y - c[1]), 0.0),
                np.where(inner, omega * (x - c[0]), 0.0))

    nu = 0.05
    params = SimParams(
        dt=5e-4, nu=nu,
        poisson=PoissonConfig(method="cg", tol=1e-7, max_iters=800),
    )
    sim = Simulation.build(g, bcs, params, sdf=sdf, surface_velocity=vel)
    assert sim.ibm is not None and sim.ibm.ub is not None
    st = sim.initial_state()
    # a few viscous gap times: (r2-r1)^2/nu = 1.25
    st, diag = sim.run_scan(st, 8000)
    assert np.isfinite(float(diag.max_div[-1]))

    # exact: u_theta = A r + B / r
    A = -omega * r1 ** 2 / (r2 ** 2 - r1 ** 2)
    B = omega * r1 ** 2 * r2 ** 2 / (r2 ** 2 - r1 ** 2)

    # sample u_x on the vertical line through the center: u_x = -u_theta
    # * (y-cy)/r there. u faces at x = i*h; the face column closest to cx.
    i_mid = n // 2  # face x = 0.5 = cx exactly
    yc = np.asarray(g.cell_centers(1))
    u_col = np.asarray(st.u[0])[i_mid, :]
    r = np.abs(yc - c[1])
    mask = (r > r1 + 2.5 / n) & (r < r2 - 2.5 / n)
    u_theta_exact = A * r + B / r
    # above the center u_x = -u_theta * sign; below it flips
    got = -u_col * np.sign(yc - c[1])
    err = np.max(np.abs(got[mask] - u_theta_exact[mask]))
    scale = omega * r1  # surface speed
    assert err < 0.04 * scale, (err, scale)


def test_rotating_cylinder_magnus_lift():
    """spin=1 cylinder at Re=200 carries a nonzero mean lift with the
    Magnus sign (counterclockwise spin with inflow +x -> mean Cl > 0:
    the upper surface moves upstream... sign per Mittal & Kumar 2003 is
    negative for alpha > 0 with u_theta = omega x r; assert magnitude and
    steadiness instead of an exact value on this coarse smoke grid)."""
    case = make_case("cylinder", shape=(96, 48), lengths=(8.0, 4.0),
                     center=(2.0, 2.0), poisson_method="mg",
                     ibm=True, spin=1.0)
    sim = case.sim
    assert sim.ibm is not None and sim.ibm.ub is not None
    # spin shows up as nonzero boundary velocity on the band
    assert float(jnp.max(jnp.abs(sim.ibm.ub[0]))) > 0.1
    st, diag = sim.run_scan(case.initial_state(), 60)
    assert np.isfinite(float(diag.max_div[-1]))
    # a moving body injects flux through the staircase interface that the
    # projection must absorb each step; a small residual interface
    # divergence (vs the solve tolerance) is inherent to direct forcing
    assert float(diag.max_div[-1]) < 5e-3
