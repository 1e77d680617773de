#!/usr/bin/env python
"""Capture a jax.profiler trace of the step loop for TensorBoard/Perfetto.

Every phase of the projection step is wrapped in jax.named_scope
(bcs / predictor / poisson / correction / diagnostics in solver.py), so the
trace shows the per-phase breakdown on the device timeline; the script also
prints the device time per phase (utils/profiling.py).

Usage:
    python scripts/profile_trace.py --case cavity --nx 2048 --ny 2048 \
        --steps 20 --out out/trace
Then: tensorboard --logdir out/trace  (or open in Perfetto).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="cavity")
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--ny", type=int, default=2048)
    ap.add_argument("--nz", type=int, default=0, help=">0 switches to 3D")
    ap.add_argument("--re", type=float, default=10_000.0)
    ap.add_argument("--poisson", default="fft")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="out/trace")
    args = ap.parse_args()

    import jax

    from navierstokessolver_tpu.utils import jaxcache as _jc
    _jc.setup()

    from navierstokessolver_tpu.cases import make_case

    shape = (args.nx, args.ny, args.nz) if args.nz else (args.nx, args.ny)
    name = "cavity3d" if (args.case == "cavity" and args.nz) else args.case
    case = make_case(
        name, shape=shape, re=args.re, poisson_method=args.poisson,
    )
    from navierstokessolver_tpu import solver as solver_mod
    from navierstokessolver_tpu.utils import profiling

    sim = case.sim
    consts = sim._consts()
    state = case.initial_state()
    # command buffers off: every kernel event then names its instruction
    compiled = solver_mod._run_scan_jit.lower(
        sim, consts, state, args.steps).compile(
            compiler_options={"xla_gpu_enable_command_buffer": ""})
    # compile + warm outside the trace window
    state, _ = compiled(consts, state)
    jax.block_until_ready(state.p)

    with jax.profiler.trace(args.out):
        state, diag = compiled(consts, state)
        jax.block_until_ready(state.p)
    print(f"[profile] {args.steps} steps traced to {args.out}", file=sys.stderr)
    prefix = ("/device:GPU" if jax.default_backend() == "gpu"
              else "/host:CPU")
    t = profiling.scope_device_times(args.out, compiled.as_text(),
                                     plane_prefix=prefix,
                                     module="jit__run_scan_jit")
    for k, v in sorted(t.items()):
        print(f"[profile] {k}: {v / args.steps * 1e3:.4f} ms/step",
              file=sys.stderr)


if __name__ == "__main__":
    main()
