"""The jnp projection step on every 2D composition the solver supports,
with euler and rk2: fields stay finite, max|div u| stays within its bound,
boundary faces hold their BC values, and float32 agrees with the float64
run of the same configuration (tests/_compositions.py)."""

import jax.numpy as jnp
import pytest

import _compositions as C

CASES = [(n, i) for n in C.COMPOSITIONS_2D for i in ("euler", "rk2")]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, integrator, dtype=jnp.float32):
        key = (name, integrator, jnp.dtype(dtype).name)
        if key not in cache:
            cache[key] = C.run(name, dtype, integrator)
        return cache[key]

    return get


@pytest.mark.parametrize("name,integrator", CASES)
def test_finite_and_divergence_bounded(runs, name, integrator):
    C.check_finite_and_divergence(*runs(name, integrator))


@pytest.mark.parametrize("name,integrator", CASES)
def test_boundary_faces_hold_bc_values(runs, name, integrator):
    C.check_boundary_faces(*runs(name, integrator))


@pytest.mark.parametrize("name,integrator", CASES)
def test_float32_matches_float64(runs, name, integrator):
    C.check_f32_matches_f64(runs(name, integrator),
                            runs(name, integrator, jnp.float64))
