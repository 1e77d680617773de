"""The GSPMD-sharded step on the compositions of tests/_compositions.py:
8 virtual devices as 'sx' slabs and as ('sx','sy') pencils, each run
against the unsharded run of the same configuration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _compositions as C
from navierstokessolver_tpu.parallel import (
    make_mesh,
    shard_state,
    sharded_simulation,
)

MESHES = {"slab": (8,), "pencil": (2, 4)}
# sharded vs unsharded, relative to max|u|: the partitioned reductions sum
# in another order, and the iterative solves stop within their tolerance
SHARD_TOL = 1e-4

CASES = (
    [(n, "euler", m) for n in C.COMPOSITIONS_3D for m in MESHES]
    + [(n, "euler", m) for n in ("cavity_fft", "cylinder_masks_dctcg",
                                  "taylor_green_periodic",
                                  "heated_cavity_buoyancy") for m in MESHES]
    + [(n, "rk2", "slab") for n in ("cavity3d_fft", "sphere_masks_dctcg")]
)


@pytest.fixture(scope="module")
def unsharded():
    cache = {}

    def get(name, integrator):
        if (name, integrator) not in cache:
            cache[(name, integrator)] = C.run(name, jnp.float32, integrator)
        return cache[(name, integrator)]

    return get


def run_sharded(name, integrator, mesh_shape, poisson_comm="gspmd"):
    sim = C.build(name, jnp.float32, integrator)
    mesh = make_mesh(mesh_shape)
    sim_sh = sharded_simulation(sim, mesh, poisson_comm=poisson_comm)
    st = shard_state(sim.initial_state(), mesh, sim.grid)
    out, d = sim_sh.run_scan(st, C.STEPS)
    return sim_sh, out, d


def assert_matches(out, ref, ndev):
    assert len(out.p.sharding.device_set) == ndev
    scale = max(C.velocity_scale(ref), 1e-30)
    for a, b in zip(out.u, ref.u):
        diff = float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        assert diff <= SHARD_TOL * scale, (diff, scale)
    if ref.t is not None:
        np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-6)


@pytest.mark.parametrize("name,integrator,mesh", CASES)
def test_gspmd_step_matches_unsharded(unsharded, name, integrator, mesh):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    _, ref, _ = unsharded(name, integrator)
    sim_sh, out, d = run_sharded(name, integrator, MESHES[mesh])
    for leaf in jax.tree_util.tree_leaves(out):
        assert np.isfinite(np.asarray(leaf)).all()
    assert_matches(out, ref, 8)
