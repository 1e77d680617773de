"""Visualization module: snapshot/stats/spectrum rendering to PNG.

Post-processing only (numpy + matplotlib Agg); asserts real PNG files come
out of real solver artifacts, and that the ``python -m`` entry points wire
through.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from navierstokessolver_tpu import io as io_mod
from navierstokessolver_tpu.cases import make_case

matplotlib = pytest.importorskip("matplotlib")


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_snapshot_2d(tmp_path):
    from navierstokessolver_tpu.viz import plot_snapshot

    case = make_case("cavity", shape=(24, 24))
    state, _ = case.sim.run_scan(case.initial_state(), 10)
    snap = tmp_path / "snap.npz"
    io_mod.write_snapshot(str(snap), case.sim.grid, state, 10, 0.5)
    out = plot_snapshot(str(snap))
    assert out == str(tmp_path / "snap.png") and _is_png(out)


def test_plot_snapshot_3d(tmp_path):
    from navierstokessolver_tpu.viz import plot_snapshot

    case = make_case("cavity3d", shape=(12, 12, 12))
    state, _ = case.sim.run_scan(case.initial_state(), 3)
    snap = tmp_path / "snap3.npz"
    io_mod.write_snapshot(str(snap), case.sim.grid, state, 3, 0.1)
    out = plot_snapshot(str(snap), str(tmp_path / "three.png"))
    assert _is_png(out)


def test_plot_stats_and_cli_dispatch(tmp_path):
    from navierstokessolver_tpu import stats as stats_mod
    from navierstokessolver_tpu.viz import main as viz_main

    case = make_case("cavity", shape=(16, 16))
    _, _, acc = case.sim.run_scan_stats(case.initial_state(), 5, None)
    p = tmp_path / "stats.npz"
    np.savez(p, **stats_mod.finalize(acc))
    rc = viz_main([str(p)])
    assert rc == 0 and _is_png(tmp_path / "stats.png")


def test_plot_spectrum(tmp_path):
    from navierstokessolver_tpu.utils import spectra
    from navierstokessolver_tpu.viz import plot_spectrum

    case = make_case("taylor_green", shape=(32, 32))
    state, _ = case.sim.run_scan(case.initial_state(), 3)
    k, E = spectra.energy_spectrum_2d(case.sim.grid, state.u)
    out = plot_spectrum(k, E, str(tmp_path / "spec.png"))
    assert _is_png(out)


def test_python_dash_m_entrypoint(tmp_path):
    """python -m navierstokessolver_tpu == the solver CLI."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "navierstokessolver_tpu", "--case", "cavity",
         "--shape", "12,12", "--steps", "1", "--chunk", "1",
         "--platform", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
