"""Pinned golden-state fidelity test (SURVEY.md SS4 fidelity tier).

The "bitwise-comparable steady state vs the reference" check is blocked on
the empty reference mount (SURVEY.md SS0), so this pins OUR OWN golden
state as the fidelity anchor: cavity Re=100, 16^2, float64, damped-Jacobi
relaxation (the reference's solver family), 200 steps, CPU. Any numerical
change to the predictor, BC handling, Poisson relaxation, or corrector
shows up here at 1e-12 scale; intentional changes must regenerate the file
(see the generator command in the module docstring of tests/golden/).

Runs in a subprocess because jax_enable_x64 is process-global.
"""

import json
import os
import subprocess
import sys

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cavity16_f64_jacobi.npz")

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from navierstokessolver_tpu.utils import jaxcache
jaxcache.setup()
import json, sys
import numpy as np
import jax.numpy as jnp
from navierstokessolver_tpu.cases import make_case

case = make_case("cavity", shape=(16, 16), re=100.0, dtype=jnp.float64,
                 poisson_method="jacobi", poisson_tol=1e-10,
                 poisson_iters=20000)
st = case.initial_state()
st, d = case.sim.run_scan(st, 200)
z = np.load(sys.argv[1])
errs = {
    "u0": float(np.abs(np.asarray(st.u[0]) - z["u0"]).max()),
    "u1": float(np.abs(np.asarray(st.u[1]) - z["u1"]).max()),
    "p": float(np.abs(np.asarray(st.p) - z["p"]).max()),
}
print(json.dumps(errs))
"""


def test_golden_cavity_state_unchanged():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT, GOLDEN],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    errs = json.loads(r.stdout.strip().splitlines()[-1])
    # f64 deterministic run: any drift here is a semantic change to the
    # numerics (1e-12 leaves room for benign cross-version reassociation)
    for k, v in errs.items():
        assert v < 1e-12, (k, errs)
