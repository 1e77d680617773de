"""Float64 validation mode (SURVEY.md SS6 fidelity ladder: bitwise-grade
comparisons need f64 on CPU; device runs are f32 tolerance-grade).

Runs in a subprocess because jax_enable_x64 is process-global."""

import json
import subprocess
import sys

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from navierstokessolver_tpu.utils import jaxcache
jaxcache.setup()
import json
import jax.numpy as jnp
import numpy as np
from navierstokessolver_tpu.cases import make_case

case = make_case("cavity", shape=(24, 24), dtype=jnp.float64,
                 poisson_method="cg", poisson_tol=1e-12, poisson_iters=20000)
st = case.initial_state()
st, diag = case.sim.run_scan(st, 50)
assert st.p.dtype == jnp.float64, st.p.dtype
assert st.u[0].dtype == jnp.float64
# determinism: same run twice is bitwise identical
st2, _ = case.sim.run_scan(case.initial_state(), 50)
bitwise = bool((np.asarray(st.u[0]) == np.asarray(st2.u[0])).all()
               and (np.asarray(st.p) == np.asarray(st2.p)).all())
print(json.dumps({
    "max_div": float(diag.max_div[-1]),
    "res": float(diag.poisson_res[-1]),
    "bitwise_repeatable": bitwise,
}))
"""


def test_f64_mode_precision_and_determinism():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=560,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # f64 + tight tol drives divergence ~10 orders below the f32 floor
    assert out["max_div"] < 1e-10, out
    assert out["res"] <= 1e-12 * 1.1, out
    assert out["bitwise_repeatable"] is True
