"""The GPU bring-up surface that runs on the CPU: the compile-cache rule,
chip_smoke.py's refusal of a non-GPU backend and its phase functions at
tiny sizes, bench.py's refusal, the trace-to-phase reduction, and the
removed kernel options raising TypeError."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokessolver_tpu.cases import make_case
from navierstokessolver_tpu.grid import GridSpec
from navierstokessolver_tpu.ops.fft_poisson import DCTPoissonSolver
from navierstokessolver_tpu.ops.multigrid import MGPoissonSolver
from navierstokessolver_tpu.parallel import make_mesh, sharded_simulation
from navierstokessolver_tpu.solver import SimParams
from navierstokessolver_tpu.utils import jaxcache, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


# -- compile cache -----------------------------------------------------------


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")


def test_setup_points_jax_at_cache_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert jaxcache.setup() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        monkeypatch.undo()
        assert jaxcache.setup() == before   # the session's own rule


def test_only_jaxcache_sets_the_cache_dir():
    needle = '"jax_compilation' + '_cache_dir"'
    hits = []
    for root, _, files in os.walk(REPO):
        if any(part.startswith(".") for part in root[len(REPO):].split(os.sep)):
            continue
        for f in files:
            if not f.endswith(".py") or f == "jaxcache.py":
                continue
            p = os.path.join(root, f)
            with open(p) as fh:
                if needle in fh.read():
                    hits.append(os.path.relpath(p, REPO))
    assert hits == []


# -- chip_smoke.py and bench.py refuse the CPU -------------------------------


def test_chip_smoke_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py", "--nx", "8", "--ny", "8"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU backend" in r.stderr
    assert r.stdout.strip() == ""


# -- chip_smoke phase functions at tiny sizes (CPU) --------------------------


def test_run_phase_reports_and_checks_contracts():
    out = {}
    case = make_case("cavity", shape=(32, 32))
    st = chip_smoke.run_phase("t", case, 5, results=out)
    r = out["t"]
    assert r["finite"] and r["res"] <= r["tol"]
    assert 0.0 <= r["max_div"] <= r["div_bound"]
    assert st.p.shape == (32, 32)


def test_run_phase_labels_capped_cg_without_failing():
    out = {}
    case = make_case("cavity", shape=(32, 32), poisson_method="cg",
                     poisson_tol=1e-9, poisson_iters=3)
    chip_smoke.run_phase("c", case, 3, results=out)
    assert out["c"]["capped"] and out["c"]["iters_max"] == 3


def test_run_phase_fails_on_non_finite_state():
    case = make_case("cavity", shape=(16, 16))
    st = case.initial_state()
    st = dataclasses.replace(st, u=(st.u[0].at[3, 3].set(jnp.nan),
                                    st.u[1]))
    with pytest.raises(AssertionError):
        chip_smoke.run_phase("n", case, 2, state=st)


def test_spectral_ref_phase():
    out = {}
    case = make_case("cavity", shape=(32, 32))
    st, _ = case.sim.run_scan(case.initial_state(), 5)
    chip_smoke.spectral_ref("s", case.sim, st, results=out)
    assert out["s"]["direct_err_highest"] < 1e-4
    assert out["s"]["default_precision"] == ["highest", "highest"]


def test_whole_step_ref_phase():
    out = {}
    chip_smoke.whole_step_ref("w", "cavity", dict(shape=(16, 16)), 5,
                              results=out)
    assert out["w"]["u_gpu32_vs_cpu64"] <= out["w"]["u_tol"]


def test_phase_trace_attributes_device_time():
    out = {}
    case = make_case("cavity3d", shape=(8, 8, 8), poisson_method="fft")
    chip_smoke.phase_trace("p", case, 2, results=out)
    ms = out["p"]["ms_per_step"]
    for scope in ("predictor", "poisson", "refine_residual", "correction"):
        assert ms.get(scope, 0.0) > 0.0, (scope, ms)


# -- trace reduction ---------------------------------------------------------


def test_hlo_scopes_take_the_innermost_scope():
    hlo = "\n".join([
        '  %fusion.1 = f32[4] fusion(%a), kind=kLoop, '
        'metadata={op_name="jit(f)/while/body/poisson/refine_residual/sub"}',
        '  ROOT %fusion.2 = f32[4] fusion(%b), kind=kLoop, '
        'metadata={op_name="jit(f)/while/body/poisson/dot_general"}',
        '  %copy.3 = f32[4] copy(%c), metadata={op_name="jit(f)/while"}',
        '  %add.4 = f32[4] add(%c, %c)',
    ])
    assert profiling.hlo_scopes(hlo) == {"fusion.1": "refine_residual",
                                         "fusion.2": "poisson"}


def test_union_of_intervals():
    assert profiling._union_ns([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


# -- removed kernel options --------------------------------------------------


def _sim():
    return make_case("cavity", shape=(8, 8)).sim


def _grid():
    return GridSpec(shape=(8, 8), lengths=(1.0, 1.0))


# the removed option names are assembled from parts, so that a search of
# the sources for them finds nothing but their absence
USE_P, INTERP, RDMA = "use_" "pallas", "pallas_" "interpret", "r" "dma"
FUSE_T = "fuse_" "trailing"


@pytest.mark.parametrize("make", [
    lambda: SimParams(dt=1e-3, nu=1e-2, **{USE_P: True}),
    lambda: dataclasses.replace(_sim(), **{INTERP: True}),
    lambda: dataclasses.replace(_sim(), **{RDMA: True}),
    lambda: sharded_simulation(_sim(), make_mesh(2), **{RDMA: True}),
    lambda: DCTPoissonSolver.build(_grid(), **{FUSE_T: True}),
    lambda: MGPoissonSolver.build(_grid(), _sim().bcs, **{USE_P: True}),
    lambda: MGPoissonSolver.build(_grid(), _sim().bcs, fused=True),
    lambda: MGPoissonSolver(grid=_grid(), ops=[], interpret=True),
], ids=["simparams", "sim_interpret", "sim_remote_dma", "sharded_remote_dma",
        "dct_trailing", "mg_kernel_sweep", "mg_fused", "mg_interpret"])
def test_removed_option_raises_type_error(make):
    with pytest.raises(TypeError):
        make()


def test_cli_rejects_remote_dma_flag():
    from navierstokessolver_tpu.cli import build_arg_parser

    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(["--" + RDMA])


def test_reference_solve_inverts_the_stencil():
    """chip_smoke.reference_solve applied to A p returns p (mean-free)."""
    from navierstokessolver_tpu.bcs import no_slip_box
    from navierstokessolver_tpu.ops.poisson import apply_A, build_poisson_op

    g = GridSpec(shape=(12, 10), lengths=(1.0, 0.7))
    op = build_poisson_op(g, no_slip_box(g), None)
    p = np.random.default_rng(1).normal(size=g.shape)
    p -= p.mean()
    with jax.enable_x64(True):
        op64 = build_poisson_op(
            GridSpec(shape=g.shape, lengths=g.lengths, dtype=jnp.float64),
            no_slip_box(g), None)
        b = np.asarray(apply_A(op64, jnp.asarray(p)))
    got = chip_smoke.reference_solve(b, g.spacing, ("nn", "nn"))
    np.testing.assert_allclose(got - got.mean(), p, atol=1e-9)
    assert op.singular


@pytest.mark.parametrize("label,name,kw,comm", [
    ("gspmd", "cavity3d", dict(shape=(16, 8, 8), poisson_method="mg"),
     "gspmd"),
    ("halo", "cavity3d", dict(shape=(16, 8, 8), poisson_method="mg"),
     "halo"),
    ("sphere_halo", "sphere", dict(shape=(32, 16, 16)), "halo"),
])
def test_four_card_phase_on_virtual_devices(label, name, kw, comm):
    """chip_smoke's --devices 4 phase on four virtual CPU devices: the
    FOUR_CARD_RUNS configurations' mechanisms at small sizes."""
    mesh = make_mesh(4)
    out = {}
    chip_smoke.sharded_phase(label, name, kw, comm, 4, mesh, results=out)
    assert out[label]["devices"] == 4
    assert {r[1] for r in chip_smoke.FOUR_CARD_RUNS} >= {name}
