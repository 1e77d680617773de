#!/usr/bin/env python
"""Smoke run of the projection solver on NVIDIA GPUs, in one JAX process.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --devices 4  # four GPUs: the sharded path only

It drives the user path (``make_case -> initial_state -> Simulation.
run_scan``, as the CLI does) at the sizes the repository supports and
checks the results by the solver's own contracts:

  device     refuse anything but a GPU backend with arrays on the GPU
  cavity_hi_re_fft   2048^2 lid-driven cavity, Re=1e4, upwind 0.8, fft
  cavity3d_fft       256^3 cavity (BASELINE #5's grid), fft
  cylinder_dctcg     2048x1024 cylinder, Re=200, dctcg
  sphere_dctcg       512x256x256 sphere, Re=300, dctcg
  cavity_mgcg / cavity_cg   the 2048^2 cavity at tol 1e-5, started from
                     the settled fft state (a capped cg solve is
                     reported CAPPED and does not fail the run)
  spectral_ref       the direct spectral solve of one real RHS per cavity
                     size against a float64 scipy.fft solve of the same
                     discrete operator, at precision "high" and "highest"
  whole_step_ref     20 steps of both cavities on the GPU in float32
                     against the same jnp code on the CPU in float64
  phase_trace        device time per named_scope phase of the 256^3
                     cavity from a jax.profiler trace

Each run phase prints steps, ms/step, MLUPS, Poisson iterations, the final
residual (diag_residual on), max|div u| against the bound the residual
contract implies, and whether any field is non-finite. Every number sits
below the card line that nvidia-smi prints first. The last line of
standard output is one JSON object, printed only when every phase passed;
any failed phase makes the exit code non-zero. The only child process is
``nvidia-smi``, which runs to completion; JAX runs in this one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# the bytes a phase must move at minimum, in units of one f32 cell field:
# predictor reads u (3 comps) and writes u* (3); correction reads u* and p,
# writes u; the refinement residual reads p and b, writes r
MIN_FIELDS_3D = {"predictor": 6, "correction": 7, "refine_residual": 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def import_package():
    """Import the solver from THIS checkout only (never an installed copy):
    run alone in an empty directory, the script must fail."""
    sys.path.insert(0, HERE)
    import navierstokessolver_tpu as nss

    pkg = os.path.dirname(os.path.abspath(nss.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"[smoke] solver package found at {pkg}, not in "
                         f"{HERE}; refusing to test another copy")
    return nss


def require_gpu(n: int):
    """The GPU backend, with at least ``n`` devices and arrays placed on
    a GPU -- not a silent CPU fallback after a failed CUDA plugin load."""
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        raise SystemExit(f"[smoke] JAX backend is {jax.default_backend()!r},"
                         " not 'gpu'; nothing was run")
    devs = jax.devices()
    if len(devs) < n:
        raise SystemExit(f"[smoke] need {n} GPUs, JAX sees {len(devs)}")
    x = jnp.zeros(8)
    plats = {d.platform for d in x.devices()}
    if plats != {"gpu"}:
        raise SystemExit(f"[smoke] arrays land on {plats}, not the GPU")
    return devs


# -- reference solve ---------------------------------------------------------


def reference_solve(b, spacing, kinds):
    """Float64 host solve of the repo's discrete pressure Laplacian
    (ghost = edge on walls, ghost = -edge on Dirichlet faces, periodic
    wrap) by scipy.fft, with the eigenvalues written out analytically --
    independent of ops/dct.py. The singular (all Neumann/periodic)
    problem returns the mean-zero solution."""
    import numpy as np
    import scipy.fft as sf

    x = np.asarray(b, np.float64)
    lam = np.zeros(x.shape)
    fwd, inv = [], []
    for a, (kind, h) in enumerate(zip(kinds, spacing)):
        n = x.shape[a]
        k = np.arange(n, dtype=np.float64)
        if kind == "nn":
            theta = np.pi * k / n
            f = (lambda y, a=a: sf.dct(y, 2, axis=a, norm="ortho"))
            g = (lambda y, a=a: sf.idct(y, 2, axis=a, norm="ortho"))
        elif kind in ("nd", "dn"):
            theta = np.pi * (2 * k + 1) / (2 * n)
            if kind == "nd":
                f = (lambda y, a=a: sf.dct(y, 4, axis=a, norm="ortho"))
                g = (lambda y, a=a: sf.idct(y, 4, axis=a, norm="ortho"))
            else:
                f = (lambda y, a=a: sf.dct(np.flip(y, a), 4, axis=a,
                                           norm="ortho"))
                g = (lambda y, a=a: np.flip(
                    sf.idct(y, 4, axis=a, norm="ortho"), a))
        elif kind == "dd":
            theta = np.pi * (k + 1) / n
            f = (lambda y, a=a: sf.dst(y, 2, axis=a, norm="ortho"))
            g = (lambda y, a=a: sf.idst(y, 2, axis=a, norm="ortho"))
        elif kind == "per":
            theta = 2.0 * np.pi * k / n
            f = (lambda y, a=a: sf.fft(y, axis=a))
            g = (lambda y, a=a: sf.ifft(y, axis=a))
        else:
            raise ValueError(f"unknown axis kind {kind!r}")
        shape = [1] * x.ndim
        shape[a] = n
        lam = lam + ((2.0 * np.cos(theta) - 2.0) / (h * h)).reshape(shape)
        fwd.append(f)
        inv.append(g)
    y = x.astype(complex) if "per" in kinds else x
    for f in fwd:
        y = f(y)
    nz = np.abs(lam) > 1e-12 * np.abs(lam).max()
    y = np.where(nz, y / np.where(nz, lam, 1.0), 0.0)
    for g in reversed(inv):
        y = g(y)
    return np.real(y)


def rel_err(got, ref, singular: bool) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if singular:
        got = got - got.mean()
        ref = ref - ref.mean()
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-300))


# -- run phases --------------------------------------------------------------


def poisson_rhs(sim, state):
    """(rhs, dt) of the pressure solve the NEXT euler step of ``sim`` would
    make from ``state`` -- a real right-hand side of the running flow."""
    import jax

    from navierstokessolver_tpu import bcs as bcs_mod

    def f(consts, st):
        s = sim._bind(consts)   # per-cell arrays as arguments, as run_scan
        g, b, pr = s.grid, s.bcs, s.params
        u = bcs_mod.apply_velocity_bcs(g, b, st.u, s.face_masks)
        dt = s._step_dt(u)
        u_star = s._predict(u, dt, s._combined_forcing(st.theta))
        return s._div(u_star) * (pr.rho / dt) * s.op.fluid, dt

    return jax.jit(f)(sim._consts(), state)


def all_finite(state) -> bool:
    import jax
    import numpy as np

    return all(bool(np.isfinite(np.asarray(x)).all())
               for x in jax.tree_util.tree_leaves(state))


def run_phase(label, case, steps, state=None, card="", results=None):
    """Compile + warm ``steps`` steps, time ``steps`` more, check the
    contracts. Returns the final state; raises AssertionError on a broken
    contract."""
    import jax
    import numpy as np

    sim = case.sim
    pr = sim.params
    st = case.initial_state() if state is None else state
    t0 = time.perf_counter()
    st, _ = sim.run_scan(st, steps)
    jax.block_until_ready(st.p)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, d = sim.run_scan(st, steps)
    jax.block_until_ready(st.p)
    wall = time.perf_counter() - t0
    ms = wall / steps * 1e3
    mlups = sim.grid.num_cells() * steps / wall / 1e6
    iters = np.asarray(d.poisson_iters)
    res = float(d.poisson_res[-1])
    max_div = float(d.max_div[-1])
    finite = all_finite(st)
    tol = pr.poisson.tol
    capped = (pr.poisson.method != "fft"
              and int(iters.max()) >= pr.poisson.max_iters)
    rhs, dt = poisson_rhs(sim, st)
    # max|div u| <= (dt/rho) ||b - A p||_2 = res * ||div u*||_2 for the
    # solve's own rhs; x2 margin since rhs is the next step's
    div_star = float(np.linalg.norm(np.asarray(rhs, np.float64))) \
        * float(dt) / pr.rho
    bound = 2.0 * max(tol, res if capped else tol) * div_star
    tag = " CAPPED" if capped else ""
    log(f"[{label}] card={card} grid={sim.grid.shape} "
        f"poisson={pr.poisson.method} steps={steps} "
        f"ms/step={ms:.4f} MLUPS={mlups:.1f} first_call_s={t_first:.1f} "
        f"iters mean={iters.mean():.2f} max={int(iters.max())}{tag} "
        f"res={res:.3e} tol={tol:.0e} max_div={max_div:.3e} "
        f"div_bound={bound:.3e} finite={finite}")
    if results is not None:
        results[label] = dict(
            grid=list(sim.grid.shape), poisson=pr.poisson.method,
            steps=steps, ms_per_step=ms, mlups=mlups,
            first_call_s=t_first, iters_mean=float(iters.mean()),
            iters_max=int(iters.max()), capped=capped, res=res, tol=tol,
            max_div=max_div, div_bound=bound, finite=finite,
        )
    assert finite, f"{label}: non-finite field"
    if not capped:
        assert 0.0 <= res <= tol, f"{label}: residual {res:.3e} > tol {tol}"
    assert max_div <= bound, \
        f"{label}: max_div {max_div:.3e} > bound {bound:.3e}"
    return st


def spectral_ref(label, sim, state, card="", results=None):
    """The direct solve of one real RHS vs the float64 scipy solve."""
    import jax
    import numpy as np

    from navierstokessolver_tpu.ops.fft_poisson import (
        DCTPoissonSolver,
        solve_with_residual,
    )

    dct = sim.dct_solver
    grid = sim.grid
    # the build-time self-check must not have fallen back to dense plans
    plain = DCTPoissonSolver.build(grid, kinds=dct.kinds, self_check=False)
    sig = [(type(p).__name__, getattr(p, "levels", None)) for p in dct.plans]
    sig0 = [(type(p).__name__, getattr(p, "levels", None))
            for p in plain.plans]
    assert sig == sig0, f"{label}: DCT self-check fell back {sig0} -> {sig}"
    rhs, _ = poisson_rhs(sim, state)
    t0 = time.perf_counter()
    ref = reference_solve(np.asarray(rhs, np.float64), grid.spacing,
                          dct.kinds)
    t_ref = time.perf_counter() - t0
    out = {"plans": [list(s) for s in sig], "ref_s": t_ref}
    # the spectral multiplier and operator ride as jit arguments, not
    # baked-in constants (64 MB each at 256^3)
    def direct(b, inv, prec):
        return dataclasses.replace(dct, inv_eig=inv)._direct(b, prec)

    def refined(b, inv, op, prec):
        s = dataclasses.replace(dct, inv_eig=inv, precision=prec,
                                refine_precision=prec)
        return solve_with_residual(s, op, b)

    for prec in ("high", "highest"):
        p = jax.jit(direct, static_argnums=2)(rhs, dct.inv_eig, prec)
        out[f"direct_err_{prec}"] = rel_err(p, ref, dct.singular)
        p, _, res = jax.jit(refined, static_argnums=3)(
            rhs, dct.inv_eig, sim.op, prec)
        out[f"refined_res_{prec}"] = float(res)
        out[f"refined_err_{prec}"] = rel_err(p, ref, dct.singular)
    p, _, res = jax.jit(
        lambda b, inv, op: solve_with_residual(
            dataclasses.replace(dct, inv_eig=inv), op, b)
    )(rhs, dct.inv_eig, sim.op)
    out["default_precision"] = [dct.precision, dct.refine_precision]
    out["default_res"] = float(res)
    out["default_err"] = rel_err(p, ref, dct.singular)
    log(f"[{label}] card={card} grid={grid.shape} kinds={dct.kinds} "
        + " ".join(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in out.items()))
    if results is not None:
        results[label] = out
    tol = sim.params.poisson.tol
    assert out["default_res"] <= tol, \
        f"{label}: default refined residual {out['default_res']:.3e} > {tol}"


def whole_step_ref(label, name, kw, steps, card="", results=None):
    """``steps`` steps on the GPU in f32 vs the same jnp code on the CPU in
    f64; the tolerance is 10x the CPU's own f32-vs-f64 difference (the
    GPU differs from the CPU by reduction order and the kernels XLA picks,
    not by arithmetic width)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from navierstokessolver_tpu.cases import make_case

    def run(dtype, device):
        with jax.default_device(device):
            case = make_case(name, dtype=dtype, **kw)
            st = jax.device_put(case.initial_state(), device)
            st, _ = case.sim.run_scan(st, steps)
            return {"u": [np.asarray(c, np.float64) for c in st.u],
                    "p": np.asarray(st.p, np.float64)}

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    t0 = time.perf_counter()
    g32 = run(jnp.float32, gpu)
    c32 = run(jnp.float32, cpu)
    with jax.enable_x64(True):
        c64 = run(jnp.float64, cpu)
    wall = time.perf_counter() - t0

    def diff(a, r):
        return float(np.max(np.abs(a - r)) / max(np.max(np.abs(r)), 1e-30))

    def pdiff(a, r):
        # pressure is defined up to a constant on the closed box
        return diff(a - a.mean(), r - r.mean())

    out = {}
    ok = True
    for field in ("u", "p"):
        if field == "u":
            d_gpu = max(diff(a, r) for a, r in zip(g32["u"], c64["u"]))
            d_cpu = max(diff(a, r) for a, r in zip(c32["u"], c64["u"]))
        else:
            d_gpu = pdiff(g32["p"], c64["p"])
            d_cpu = pdiff(c32["p"], c64["p"])
        tol = max(10.0 * d_cpu, 1e-6)
        out[f"{field}_gpu32_vs_cpu64"] = d_gpu
        out[f"{field}_cpu32_vs_cpu64"] = d_cpu
        out[f"{field}_tol"] = tol
        ok = ok and d_gpu <= tol
    log(f"[{label}] card={card} case={name} {kw} steps={steps} "
        f"wall_s={wall:.1f} "
        + " ".join(f"{k}={v:.3e}" for k, v in out.items()))
    if results is not None:
        results[label] = out
    assert ok, f"{label}: GPU f32 vs CPU f64 outside tolerance {out}"


def phase_trace(label, case, steps, card="", kind="", results=None):
    """Device time per projection phase of ``case`` from one profiler
    trace, with the predictor/correction/refinement-residual bandwidth
    against the card's HBM peak."""
    import jax

    from navierstokessolver_tpu import solver as solver_mod
    from navierstokessolver_tpu.utils import profiling

    sim = case.sim
    consts = sim._consts()
    st = case.initial_state()
    # the run_scan program, compiled with command buffers (CUDA graphs)
    # off so that every kernel event names the instruction it ran
    compiled = solver_mod._run_scan_jit.lower(sim, consts, st, steps).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    st, _ = compiled(consts, st)
    jax.block_until_ready(st.p)
    hlo = compiled.as_text()
    with tempfile.TemporaryDirectory(prefix="nss_trace_") as trace_dir:
        with jax.profiler.trace(trace_dir):
            st, _ = compiled(consts, st)
            jax.block_until_ready(st.p)
        # device events live on the GPU planes; a CPU run records its
        # XLA ops on the host plane
        prefix = ("/device:GPU" if jax.default_backend() == "gpu"
                  else "/host:CPU")
        other: dict = {}
        t = profiling.scope_device_times(trace_dir, hlo, plane_prefix=prefix,
                                         module="jit__run_scan_jit",
                                         unmatched=other)
    per_step = {k: v / steps for k, v in t.items()}
    ms = {k: v * 1e3 for k, v in per_step.items()}
    line = " ".join(f"{k}_ms={v:.4f}" for k, v in sorted(ms.items()))
    log(f"[{label}] card={card} grid={sim.grid.shape} steps={steps} "
        f"per-step device time: {line} "
        f"idle_share={1.0 - t['busy'] / max(t['window'], 1e-30):.4f}")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{label}] card={card} largest unattributed events: "
        + ", ".join(f"{k}={v / steps * 1e3:.4f}ms" for k, v in top))
    peak = (profiling.device_peaks(kind)["hbm_bytes_s"]
            if jax.default_backend() == "gpu" else None)
    roof = {}
    for scope, fields in MIN_FIELDS_3D.items():
        sec = per_step.get(scope, 0.0)
        nbytes = fields * sim.grid.num_cells() * 4
        bw = nbytes / sec if sec > 0 else float("nan")
        share = bw / peak if peak else float("nan")
        roof[scope] = dict(ms=sec * 1e3, min_bytes=nbytes,
                           achieved_gb_s=bw / 1e9, hbm_share=share)
        log(f"[{label}] card={card} {scope}: {sec * 1e3:.4f} ms, "
            f"min bytes {nbytes / 1e6:.1f} MB, "
            f"{bw / 1e9:.1f} GB/s = {share:.3f} of "
            f"{(peak or float('nan')) / 1e12:.2f} TB/s")
    if results is not None:
        results[label] = dict(ms_per_step=ms, roofline=roof)
    assert t.get("total", 0.0) > 0.0, f"{label}: no device events traced"


# -- drivers -----------------------------------------------------------------


def single_card(card, kind, results, failures):
    from navierstokessolver_tpu.cases import make_case

    def phase(label, fn, *a, **kw):
        log(f"[smoke] phase {label} ...")
        try:
            return fn(label, *a, card=card, results=results, **kw)
        except Exception:  # record, run the remaining phases, exit 1
            failures.append(label)
            log(f"[{label}] FAILED\n{traceback.format_exc()}")
            return None

    hi = make_case("cavity_hi_re")
    st_hi = phase("cavity_hi_re_fft", run_phase, hi, 100)
    c3 = make_case("cavity3d", shape=(256, 256, 256), poisson_method="fft")
    st_3d = phase("cavity3d_fft", run_phase, c3, 20)
    if st_hi is not None:
        phase("spectral_ref_2048", spectral_ref, hi.sim, st_hi)
    if st_3d is not None:
        phase("spectral_ref_256", spectral_ref, c3.sim, st_3d)
    phase("cylinder_dctcg", run_phase,
          make_case("cylinder", shape=(2048, 1024)), 20)
    phase("sphere_dctcg", run_phase,
          make_case("sphere", shape=(512, 256, 256)), 10)
    if st_hi is not None:
        for method in ("mgcg", "cg"):
            c = make_case("cavity_hi_re", poisson_method=method,
                          poisson_tol=1e-5)
            phase(f"cavity_{method}", run_phase, c, 10, state=st_hi)
    phase("whole_step_ref_2048", whole_step_ref, "cavity_hi_re", {}, 20)
    phase("whole_step_ref_256", whole_step_ref, "cavity3d",
          dict(shape=(256, 256, 256), poisson_method="fft"), 20)
    phase("phase_trace_256", phase_trace, c3, 5, kind=kind)


# the four-card runs: (label, case, overrides, poisson_comm, steps)
FOUR_CARD_RUNS = (
    ("cavity3d_mg_gspmd", "cavity3d",
     dict(shape=(256, 256, 256), poisson_method="mg"), "gspmd", 10),
    ("cavity3d_mg_halo", "cavity3d",
     dict(shape=(256, 256, 256), poisson_method="mg"), "halo", 10),
    ("sphere_dctcg_halo", "sphere", dict(shape=(512, 256, 256)), "halo", 5),
)


def sharded_phase(label, name, kw, comm, steps, mesh, card="", results=None):
    """``steps`` steps of ``name`` sharded over ``mesh`` (GSPMD or the
    explicit-halo pressure solve) against the single-card run of the same
    configuration, then ``steps`` more timed."""
    import jax
    import numpy as np

    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.parallel import shard_state, sharded_simulation

    case = make_case(name, **kw)
    ref, _ = case.sim.run_scan(
        jax.device_put(case.initial_state(), jax.devices()[0]), steps)
    ref_u = [np.asarray(c) for c in ref.u]
    ref_p = np.asarray(ref.p)
    sim = sharded_simulation(case.sim, mesh, poisson_comm=comm)
    st = shard_state(case.initial_state(), mesh, sim.grid)
    out1, _ = sim.run_scan(st, steps)    # compile + the compared run
    jax.block_until_ready(out1.p)
    t0 = time.perf_counter()
    out, d = sim.run_scan(out1, steps)
    jax.block_until_ready(out.p)
    wall = time.perf_counter() - t0
    ndev = len(out.p.sharding.device_set)
    scale = max(float(np.max(np.abs(r))) for r in ref_u)
    du = max(float(np.max(np.abs(np.asarray(a) - r)))
             for a, r in zip(out1.u, ref_u)) / scale
    p1 = np.asarray(out1.p)
    dp = float(np.max(np.abs((p1 - p1.mean()) - (ref_p - ref_p.mean())))) \
        / max(float(np.max(np.abs(ref_p - ref_p.mean()))), 1e-30)
    # both runs stop their iterative solves within tol; 10x tol covers
    # the partitioned reductions' other summation order
    tol = 10.0 * case.sim.params.poisson.tol
    ms = wall / steps * 1e3
    mlups = sim.grid.num_cells() * steps / wall / 1e6
    iters = np.asarray(d.poisson_iters)
    finite = all_finite(out)
    log(f"[{label}] card={card} devices={ndev} grid={sim.grid.shape} "
        f"poisson={case.sim.params.poisson.method} comm={comm} "
        f"steps={steps} ms/step={ms:.4f} MLUPS={mlups:.1f} "
        f"iters mean={iters.mean():.2f} "
        f"res={float(d.poisson_res[-1]):.3e} "
        f"max_div={float(d.max_div[-1]):.3e} "
        f"u_rel_diff={du:.3e} p_rel_diff={dp:.3e} tol={tol:.0e} "
        f"finite={finite}")
    if results is not None:
        results[label] = dict(devices=ndev, ms_per_step=ms, mlups=mlups,
                              u_rel_diff=du, p_rel_diff=dp, tol=tol)
    assert ndev == mesh.devices.size, f"{label}: state on {ndev} devices"
    assert finite, f"{label}: non-finite field"
    assert du <= tol and dp <= tol, \
        f"{label}: sharded vs single-card {du:.3e}/{dp:.3e} > {tol}"


def four_cards(card, results, failures):
    """The sharded path on a 4-GPU 'sx' slab mesh, each run against the
    single-card run of the same configuration."""
    from navierstokessolver_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    for label, name, kw, comm, steps in FOUR_CARD_RUNS:
        log(f"[smoke] phase {label} ...")
        try:
            sharded_phase(label, name, kw, comm, steps, mesh, card=card,
                          results=results)
        except Exception:  # record, run the remaining phases, exit 1
            failures.append(label)
            log(f"[{label}] FAILED\n{traceback.format_exc()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: every single-GPU phase; 4: only the sharded "
                         "path and its single-card comparison")
    args = ap.parse_args(argv)

    import_package()
    import jax

    from navierstokessolver_tpu.utils import jaxcache

    jaxcache.setup()
    devs = require_gpu(args.devices)
    cards = card_lines()
    os.makedirs(OUT_DIR, exist_ok=True)
    card = cards[0] if cards else "unknown"
    for ln in cards:
        log(f"[device] nvidia-smi: {ln}")
    kind = devs[0].device_kind
    log(f"[device] jax {jax.__version__} backend={jax.default_backend()} "
        f"kind={kind} count={len(devs)}")

    results: dict = {"card": cards, "device_kind": kind}
    failures: list = []
    if args.devices == 4:
        four_cards(card, results, failures)
    else:
        single_card(card, kind, results, failures)
    with open(os.path.join(OUT_DIR, f"chip_smoke_{args.devices}.json"),
              "w") as fh:
        json.dump(dict(results, failures=failures), fh, indent=1)
    if failures:
        log(f"[smoke] FAILED phases: {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
