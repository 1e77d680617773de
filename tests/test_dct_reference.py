"""The spectral solve's transform chain against an independent float64
scipy.fft solve of the same discrete operator (chip_smoke.reference_solve),
for every axis kind in 2D and 3D and across the radix-split plans."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops import dct as dct_mod
from navierstokessolver_tpu.ops.fft_poisson import DCTPoissonSolver

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# (kinds, shape, split_levels, expected plan class of axis 0)
CASES = [
    (("nn", "nn"), (32, 16), 0, "SplitPlan"),
    (("nn", "nn"), (64, 16), 1, "SplitPlan"),
    (("nn", "nn"), (64, 16), 2, "SplitPlan"),
    (("nn", "nn"), (1024, 4), None, "SplitPlan"),
    (("per", "nn"), (16, 12), None, "DensePlan"),
    (("per", "nn"), (1024, 4), None, "CircSplitPlan"),
    (("nd", "nn"), (16, 12), None, "DensePlan"),
    (("nd", "nn"), (512, 4), None, "Dct4SplitPlan"),
    (("dn", "nn"), (16, 12), None, "DensePlan"),
    (("dn", "per"), (512, 4), None, "Dct4SplitPlan"),
    (("dd", "nn"), (16, 12), None, "DensePlan"),
    (("dd", "dd"), (12, 10), None, "DensePlan"),
    (("nn", "per"), (16, 12), None, "SplitPlan"),
    (("per", "per"), (16, 16), None, "DensePlan"),
    (("nd", "dn"), (12, 16), None, "DensePlan"),
    (("nn", "nn", "nn"), (8, 8, 8), None, "SplitPlan"),
    (("nn", "nn", "nn"), (16, 8, 8), 1, "SplitPlan"),
    (("per", "per", "per"), (8, 8, 8), None, "DensePlan"),
    (("nd", "nn", "nn"), (12, 8, 6), None, "DensePlan"),
    (("dn", "nn", "per"), (12, 8, 6), None, "DensePlan"),
    (("dd", "nn", "nn"), (10, 8, 6), None, "DensePlan"),
    (("nn", "per", "nd"), (8, 6, 10), None, "SplitPlan"),
    (("per", "nn", "dd"), (8, 6, 10), None, "DensePlan"),
    (("nn", "nn", "dn"), (8, 8, 12), None, "SplitPlan"),
]


def _rhs(shape, singular, seed=0):
    b = np.random.default_rng(seed).normal(size=shape)
    return b - b.mean() if singular else b


@pytest.mark.parametrize("kinds,shape,levels,plan0", CASES)
def test_direct_solve_matches_scipy_reference(kinds, shape, levels, plan0):
    g = GridSpec(shape=shape, lengths=tuple(0.5 + 0.1 * a
                                            for a in range(len(shape))))
    s = DCTPoissonSolver.build(g, kinds=kinds, split_levels=levels)
    assert type(s.plans[0]).__name__ == plan0
    b = _rhs(shape, s.singular)
    p = np.asarray(jax.jit(s._direct)(jnp.asarray(b, jnp.float32)))
    ref = chip_smoke.reference_solve(b, g.spacing, kinds)
    err = chip_smoke.rel_err(p, ref, s.singular)
    assert err < 2e-5, err


@pytest.mark.parametrize("kind", ["nn", "nd", "dn", "dd", "per"])
def test_reference_eigenvalues_match_ops_dct(kind):
    """The reference's analytic eigenvalues agree with ops/dct.py's: a
    single eigenmode comes back scaled by 1/lambda."""
    n, h = 16, 0.25
    lam = {"nn": dct_mod.neumann_eigenvalues, "dd": dct_mod.dirichlet_eigenvalues,
           "nd": dct_mod.mixed_nd_eigenvalues, "dn": dct_mod.mixed_nd_eigenvalues,
           }.get(kind)
    i = np.arange(n) + 0.5
    k = 3
    if kind == "nn":
        mode = np.cos(np.pi * k * i / n)
    elif kind == "nd":
        mode = np.cos(np.pi * (2 * k + 1) * i / (2 * n))
    elif kind == "dn":
        mode = np.cos(np.pi * (2 * k + 1) * (n - i) / (2 * n))
    elif kind == "dd":
        mode = np.sin(np.pi * (k + 1) * i / n)
    else:
        mode = np.cos(2 * np.pi * k * np.arange(n) / n)
    lam_k = (lam(n, h)[k] if lam is not None
             else (2 * np.cos(2 * np.pi * k / n) - 2) / (h * h))
    got = chip_smoke.reference_solve(mode, (h,), (kind,))
    np.testing.assert_allclose(got, mode / lam_k, rtol=1e-10, atol=1e-12)
