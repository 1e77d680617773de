"""Sharded pressure solves and gradients on 8 virtual devices: the
explicit-halo solvers (poisson_comm="halo") for the iterative and
spectrally-preconditioned methods, and reverse-mode gradients through the
GSPMD-sharded scan, each against the unsharded run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu import adjoint
from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.parallel import (
    make_mesh,
    shard_state,
    sharded_simulation,
)

HALO = {
    "cavity3d_cg": ("cavity3d", dict(shape=(16, 8, 8), poisson_method="cg")),
    "cavity3d_mg": ("cavity3d", dict(shape=(16, 8, 8), poisson_method="mg")),
    "cavity3d_mgcg": ("cavity3d", dict(shape=(16, 8, 8),
                                       poisson_method="mgcg")),
    "heated_cavity3d_mg": ("heated_cavity", dict(shape=(16, 8, 8),
                                                 poisson_method="mg")),
    "sphere_dctcg": ("sphere", dict(shape=(32, 16, 16),
                                    lengths=(16.0, 8.0, 8.0))),
    "sphere_mg": ("sphere", dict(shape=(32, 16, 16),
                                 lengths=(16.0, 8.0, 8.0),
                                 poisson_method="mg")),
    "cavity2d_sor": ("cavity", dict(shape=(32, 32), poisson_method="sor",
                                    poisson_iters=4000)),
    "cylinder2d_dctcg": ("cylinder", dict(shape=(64, 32),
                                          lengths=(8.0, 4.0),
                                          center=(2.0, 2.03))),
}


def _needs_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


@pytest.mark.parametrize("key", list(HALO))
def test_halo_solver_matches_unsharded(key):
    _needs_8()
    name, kw = HALO[key]
    case = make_case(name, **kw)
    steps = 4
    ref, dref = case.sim.run_scan(case.initial_state(), steps)
    mesh = make_mesh(8)
    sim_h = sharded_simulation(case.sim, mesh, poisson_comm="halo")
    assert sim_h.halo_solver is not None
    out, d = sim_h.run_scan(
        shard_state(case.initial_state(), mesh, case.sim.grid), steps)
    assert len(out.p.sharding.device_set) == 8
    tol = 10.0 * case.sim.params.poisson.tol
    scale = max(float(np.max(np.abs(np.asarray(c)))) for c in ref.u)
    for a, b in zip(out.u, ref.u):
        diff = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        assert diff <= tol * scale, (diff, scale)
    assert float(np.asarray(d.poisson_res)[-1]) <= case.sim.params.poisson.tol


GRAD = {
    "cavity3d_cg_euler_slab": ("cavity3d", dict(
        shape=(16, 8, 8), re=100.0, poisson_method="cg", poisson_tol=1e-6,
        poisson_iters=2000), (8,)),
    "cavity3d_cg_rk2_pencil": ("cavity3d", dict(
        shape=(16, 8, 8), re=100.0, poisson_method="cg", poisson_tol=1e-6,
        poisson_iters=2000, integrator="rk2"), (2, 4)),
    "cavity2d_fft_slab": ("cavity", dict(shape=(32, 32)), (8,)),
    "sphere_dctcg_slab": ("sphere", dict(
        shape=(32, 16, 16), lengths=(16.0, 8.0, 8.0)), (8,)),
    "heated_cavity3d_slab": ("heated_cavity", dict(
        shape=(16, 8, 8), ra=1e4, poisson_tol=1e-6), (8,)),
}


@pytest.mark.parametrize("key", list(GRAD))
def test_gradient_through_gspmd_matches_unsharded(key):
    """jax.grad of sum(u^2) after two steps w.r.t. an initial u[0]
    perturbation, through the differentiable GSPMD scan vs unsharded."""
    _needs_8()
    name, kw, mesh_shape = GRAD[key]
    case = make_case(name, **kw)
    mesh = make_mesh(mesh_shape)
    d_un = adjoint.differentiable(case.sim)
    d_sh = adjoint.differentiable(sharded_simulation(case.sim, mesh))
    st = case.initial_state()
    st_sh = shard_state(case.initial_state(), mesh, case.sim.grid)

    def loss_of(sim, st0):
        def loss(du):
            s = dataclasses.replace(st0, u=(st0.u[0] + du,) + st0.u[1:])
            s, _ = sim.run_scan(s, 2)
            return sum(jnp.sum(u ** 2) for u in s.u)
        return loss

    g_un = np.asarray(jax.grad(loss_of(d_un, st))(jnp.zeros_like(st.u[0])))
    g_sh = np.asarray(jax.grad(loss_of(d_sh, st_sh))(
        jnp.zeros_like(st_sh.u[0])))
    assert np.isfinite(g_sh).all() and np.abs(g_sh).max() > 0
    # the IFT gradient is exact to the solver tolerance
    rel = max(3e-5, 10.0 * case.sim.params.poisson.tol)
    np.testing.assert_allclose(g_sh, g_un,
                               atol=rel * float(np.abs(g_un).max()))
