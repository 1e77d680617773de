#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line for the driver.

Metric (BASELINE.json): cell updates/sec (MLUPS) per GPU for the full
projection step loop. One lattice update = one complete time step for one
cell (predictor + pressure Poisson to fixed residual + correction). The
headline is the median over the timed chunks. Refuses to run without a GPU.

Extra diagnostics (wall-clock/step, Poisson iters) go to stderr; stdout is
exactly one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="cavity")
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=2048)
    ap.add_argument("--nz", type=int, default=0, help=">0 switches to 3D")
    ap.add_argument("--re", type=float, default=10_000.0)
    ap.add_argument("--ra", type=float, default=1e6,
                    help="Rayleigh number (heated_cavity / rayleigh_benard)")
    # Default = the flagship configuration: direct spectral (DCT) pressure
    # solve, the fastest exact method for the closed cavity. `cg`/`mg` cover
    # the iterative paths (BASELINE "Poisson iters" metric).
    ap.add_argument("--poisson", default="fft")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--les-cs", type=float, default=0.0,
                    help=">0 enables the Smagorinsky LES closure (jnp path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--chunks", type=int, default=5,
                    help="timed chunks; the reported number is their median")
    ap.add_argument("--no-companion", action="store_true",
                    help="skip the iterative-solver (cg) companion line")
    args = ap.parse_args()

    import jax

    from navierstokessolver_tpu.utils import jaxcache

    jaxcache.setup()

    from navierstokessolver_tpu.cases import make_case

    dev = jax.devices()[0]
    if jax.default_backend() != "gpu" or dev.platform != "gpu":
        sys.exit(f"[bench] no GPU backend (got {jax.default_backend()!r}); "
                 "refusing to report CPU timings")
    print(f"[bench] device: {dev.device_kind} ({dev.platform}) "
          f"x{len(jax.devices())}", file=sys.stderr)

    shape = (args.nx, args.ny, args.nz) if args.nz else (args.nx, args.ny)
    kw = dict(shape=shape, re=args.re, poisson_method=args.poisson,
              poisson_tol=args.tol)
    if args.case in ("cavity", "cavity_hi_re", "cavity3d"):
        case = make_case("cavity" if not args.nz else "cavity3d",
                         upwind_gamma=0.8 if args.re > 1000 else 0.0, **kw)
    elif args.case in ("heated_cavity", "rayleigh_benard"):
        kw.pop("re")
        case = make_case(args.case, ra=args.ra, **kw)
    else:
        case = make_case(args.case, **kw)
    sim = case.sim
    if args.les_cs > 0.0:
        import dataclasses as _dc

        from navierstokessolver_tpu.les import LESConfig

        sim = _dc.replace(sim, les=LESConfig(cs=args.les_cs))
    # Time the production configuration: for the direct (fft) solve the
    # exact per-step residual report is an extra stencil pass purely for
    # diagnostics -- skip it in the timed loop and measure the true
    # residual once afterwards with a diagnostic-enabled sim.
    import dataclasses

    sim_diag = sim
    if args.poisson == "fft":
        sim = dataclasses.replace(
            sim,
            params=dataclasses.replace(
                sim.params,
                poisson=dataclasses.replace(
                    sim.params.poisson, diag_residual=False
                ),
            ),
        )
    n_cells = sim.grid.num_cells()

    # Warmup and measurement reuse the SAME chunk length: run_scan compiles
    # per static scan length, so a different measured length would fold a
    # fresh multi-minute compile into the timing. --warmup counts EXTRA
    # post-compile warmup steps (ceil'd to whole chunks) beyond the compile
    # chunk itself.
    chunk = args.steps
    extra_warm_chunks = -(-args.warmup // chunk) if args.warmup else 0

    state = case.initial_state()
    t0 = time.perf_counter()
    state, diag = sim.run_scan(state, chunk)
    jax.block_until_ready(state.p)
    t_warm = time.perf_counter() - t0
    print(
        f"[bench] warmup chunk of {chunk} steps (incl. compile): {t_warm:.1f}s; "
        f"poisson iters last={int(diag.poisson_iters[-1])}",
        file=sys.stderr,
    )
    for _ in range(extra_warm_chunks):
        state, diag = sim.run_scan(state, chunk)
    jax.block_until_ready(state.p)

    chunk_times = []
    for _ in range(max(1, args.chunks)):
        t0 = time.perf_counter()
        state, diag = sim.run_scan(state, chunk)
        jax.block_until_ready(state.p)
        chunk_times.append(time.perf_counter() - t0)

    import numpy as np

    elapsed = float(np.median(chunk_times))
    spread = {
        "best_ms": round(min(chunk_times) / chunk * 1e3, 3),
        "median_ms": round(
            float(np.median(chunk_times)) / chunk * 1e3, 3),
        "worst_ms": round(max(chunk_times) / chunk * 1e3, 3),
    }
    iters = np.asarray(diag.poisson_iters)
    mlups = n_cells * chunk / elapsed / 1e6
    ms_per_step = elapsed / chunk * 1e3
    print(f"[bench] chunk spread (ms/step): {spread}", file=sys.stderr)
    final_res = float(diag.poisson_res[-1])
    if sim_diag is not sim:
        # one diagnostic step with exact residual reporting re-enabled
        _, dg = sim_diag.run_scan(state, 1)
        final_res = float(dg.poisson_res[-1])
    print(
        f"[bench] {chunk} steps in {elapsed:.3f}s -> {ms_per_step:.2f} ms/step, "
        f"{mlups:.1f} MLUPS; poisson iters mean={iters.mean():.1f} "
        f"min={iters.min()} max={iters.max()}; "
        f"final res={final_res:.2e} "
        f"max_div={float(diag.max_div[-1]):.2e}",
        file=sys.stderr,
    )

    dims = f"{args.nx}x{args.ny}" + (f"x{args.nz}" if args.nz else "")
    nd = "3d" if args.nz else "2d"

    if args.poisson == "fft" and not args.no_companion:
        # Iterative-solver companion datapoints (stderr only; the JSON line
        # stays the flagship config): the BASELINE spec names matrix-free
        # CG on config #4. A cold-start cg solve caps at max_iters
        # (impulsive-start RHS + the f32 residual floor), so start from the
        # HEADLINE run's final state (same case, pytree-compatible:
        # extrapolate=0 on both sides), report cg AND mgcg, and label a
        # capped solve CAPPED.
        for method in ("cg", "mgcg"):
            try:
                kw_it = dict(kw, poisson_method=method)
                if args.case in ("cavity", "cavity_hi_re", "cavity3d"):
                    case_it = make_case(
                        "cavity" if not args.nz else "cavity3d",
                        upwind_gamma=0.8 if args.re > 1000 else 0.0,
                        **kw_it)
                elif args.case in ("heated_cavity", "rayleigh_benard"):
                    kw_it.pop("re", None)
                    case_it = make_case(args.case, ra=args.ra, **kw_it)
                else:
                    case_it = make_case(args.case, **kw_it)
                sim_it = case_it.sim
                cchunk = max(20, chunk // 5)
                st_it, _ = sim_it.run_scan(state, cchunk)
                jax.block_until_ready(st_it.p)   # compile + settle
                t0 = time.perf_counter()
                st_it, dg_it = sim_it.run_scan(st_it, cchunk)
                jax.block_until_ready(st_it.p)
                t_it = time.perf_counter() - t0
                it_it = np.asarray(dg_it.poisson_iters)
                cap = sim_it.params.poisson.max_iters
                res_it = float(dg_it.poisson_res[-1])
                tag = " CAPPED" if int(it_it.max()) >= cap else ""
                print(
                    f"[bench] {method} companion ({dims}, from headline "
                    f"state): {n_cells * cchunk / t_it / 1e6:.1f} MLUPS, "
                    f"{t_it / cchunk * 1e3:.2f} ms/step, "
                    f"iters mean={it_it.mean():.1f} max={it_it.max()}, "
                    f"res={res_it:.2e} (tol {sim_it.params.poisson.tol:.0e})"
                    f"{tag}",
                    file=sys.stderr,
                )
            except Exception as e:  # pragma: no cover - keep headline safe
                print(
                    f"[bench] {method} companion skipped "
                    f"({type(e).__name__}: {e})", file=sys.stderr)

    line = {
        "metric": f"{nd}_step_loop_mlups_{dims}_{args.poisson}",
        "value": round(mlups, 1),
        "unit": "MLUPS/gpu",
        "spread_ms_per_step": spread,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
