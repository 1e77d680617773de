#!/usr/bin/env python
"""Multi-device (domain-decomposed) step-loop benchmark.

Runs the full projection step sharded over ALL visible devices via GSPMD
domain decomposition (parallel/sharding.py): grid axes map onto the spatial
mesh, XLA inserts the halo collective-permutes and psums for the global
reductions (NCCL on GPUs).

On a multi-GPU host this measures multi-device MLUPS; with
``--platform cpu --devices 8`` it only validates the sharded program on
virtual CPU devices (CPU times are not device measurements).

Prints one JSON line: {"metric": ..., "value": MLUPS, ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="cavity")
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=2048)
    ap.add_argument("--nz", type=int, default=0)
    ap.add_argument("--re", type=float, default=10_000.0)
    ap.add_argument("--poisson", default="fft")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="", help="e.g. 2,4 (default: 1D over all devices)")
    ap.add_argument("--poisson-comm", default="gspmd",
                    choices=["gspmd", "halo"],
                    help="distributed pressure solve mechanism")
    ap.add_argument("--devices", type=int, default=8,
                    help="virtual CPU device count (with --platform cpu)")
    ap.add_argument("--platform", default="",
                    help="force backend (e.g. 'cpu', with --devices "
                         "virtual devices)")
    args = ap.parse_args()

    import jax
    import numpy as np

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu" and args.devices > 1:
            jax.config.update("jax_num_cpu_devices", args.devices)
    from navierstokessolver_tpu.utils import jaxcache as _jc
    _jc.setup()

    from navierstokessolver_tpu.cases import make_case
    from navierstokessolver_tpu.parallel import (
        make_mesh, shard_state, sharded_simulation,
    )

    devs = jax.devices()
    n_dev = len(devs)
    mesh_shape = (
        tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (n_dev,)
    )
    mesh = make_mesh(mesh_shape)
    print(f"[bench_sharded] {n_dev} x {devs[0].device_kind}, mesh={mesh_shape}",
          file=sys.stderr)

    shape = (args.nx, args.ny, args.nz) if args.nz else (args.nx, args.ny)
    case = make_case(args.case, shape=shape, re=args.re,
                     poisson_method=args.poisson)
    sim = sharded_simulation(case.sim, mesh, poisson_comm=args.poisson_comm)
    state = shard_state(case.initial_state(), mesh, sim.grid)
    n_cells = sim.grid.num_cells()

    chunk = args.steps
    t0 = time.perf_counter()
    state, diag = sim.run_scan(state, chunk)
    jax.block_until_ready(state.p)
    print(f"[bench_sharded] warmup chunk (incl. compile): "
          f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    state, diag = sim.run_scan(state, chunk)
    jax.block_until_ready(state.p)
    el = time.perf_counter() - t0
    mlups = n_cells * chunk / el / 1e6
    assert len(state.p.sharding.device_set) == n_dev
    print(
        f"[bench_sharded] {chunk} steps in {el:.3f}s -> "
        f"{el/chunk*1e3:.2f} ms/step; res={float(diag.poisson_res[-1]):.2e} "
        f"max_div={float(diag.max_div[-1]):.2e}", file=sys.stderr,
    )
    dims = "x".join(str(s) for s in shape)
    print(json.dumps({
        "metric": f"sharded_step_loop_mlups_{dims}_{args.poisson}"
                  f"_{n_dev}dev",
        "value": round(mlups, 1),
        "unit": "MLUPS",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": n_dev},
    }))


if __name__ == "__main__":
    main()
