#!/usr/bin/env python
"""Roofline model of the flagship configs against a device's published peaks.

Models per-step device-memory bytes and transform FLOPs from the algorithm
structure (the jnp step, spectral transforms at precision "highest", i.e.
full f32 outside the tensor cores) and prints each config's lower bound on
time. Measured times come from the command line, never from this file:

    python scripts/roofline.py --kind "NVIDIA H100 80GB HBM3" \
        --measured 2048_fft=1.66 --measured 256_fft=4.13

(e.g. the ms/step lines of ``python chip_smoke.py``). Pure arithmetic --
runs anywhere.

Model assumptions (stated so the table is checkable):
  * elementwise chains fuse (XLA): each logical PASS reads its inputs
    once and writes its outputs once at f32 (4 B);
  * stencil neighbor reads come from cache (no re-reads);
  * a dense axis-N transform of the whole grid costs 2*N*cells FLOPs and
    one read+write pass; radix-split at L levels divides the FLOPs by
    ~2^min(L,2) (block-diagonal fold) -- 2048-axis transforms run L4 ~= /4.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config_2048_fft():
    n = 2048
    cells = n * n
    arr = cells * 4
    # predictor(read u,v -> write u*,v*), div+rhs(read 2 -> write 1),
    # residual (read p,rhs -> write r), correct (read 3 -> write 2)
    stencil_bytes = (4 + 3 + 3 + 5) * arr
    # refined solve: 2 chains (main+refine), 4 axis transforms each
    chain_passes = 4
    dct_bytes = 2 * chain_passes * 2 * arr
    flops = 2 * chain_passes * 2 * n * cells / 4      # split L4
    return dict(key="2048_fft", name="2048^2 cavity fft", cells=cells,
                bytes=stencil_bytes + dct_bytes, flops=flops)


def config_256_fft():
    n = 256
    cells = n ** 3
    arr = cells * 4
    # predictor (read 3 -> write 3), rhs (read 3 -> write 1), refinement
    # residual (read 2 -> write 1), correction (read 4 -> write 3)
    stencil_bytes = (6 + 4 + 3 + 7) * arr
    # dense (no split below 1024): 3 axes fwd + 3 inv per chain, 2 chains
    chain_passes = 6
    dct_bytes = 2 * chain_passes * 2 * arr
    flops = 2 * chain_passes * 2 * n * cells
    return dict(key="256_fft", name="256^3 cavity fft", cells=cells,
                bytes=stencil_bytes + dct_bytes, flops=flops)


def config_sphere_dctcg():
    shape = (512, 256, 256)
    cells = shape[0] * shape[1] * shape[2]
    arr = cells * 4
    stencil_bytes = (6 + 4 + 7 + 2) * arr
    # one Richardson sweep = one capacitance preconditioner application =
    # TWO spectral chains + residual/norm passes
    chain_passes = 6
    dct_bytes = 2 * chain_passes * 2 * arr + 4 * arr
    per_chain = 2 * cells * (512 + 256 + 256) * 2     # fwd + inv
    flops = 2 * per_chain
    return dict(key="sphere_dctcg", name="512x256x256 sphere dctcg",
                cells=cells, bytes=stencil_bytes + dct_bytes, flops=flops)


def main(argv=None) -> int:
    from navierstokessolver_tpu.utils.profiling import device_peaks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True,
                    help="device kind, as jax.devices()[0].device_kind")
    ap.add_argument("--measured", action="append", default=[],
                    help="CONFIG=ms_per_step from a chip run")
    args = ap.parse_args(argv)
    peaks = device_peaks(args.kind)
    measured = dict(m.split("=") for m in args.measured)
    print(f"{'config':28s} {'GB/step':>8s} {'GFLOP':>7s} {'t_bw':>6s} "
          f"{'t_f32':>6s} {'floor':>6s} {'meas':>7s} {'share':>6s} bound")
    for r in (config_2048_fft(), config_256_fft(), config_sphere_dctcg()):
        t_bw = r["bytes"] / peaks["hbm_bytes_s"] * 1e3
        t_fl = r["flops"] / peaks["f32_flops"] * 1e3
        floor = max(t_bw, t_fl)
        meas = float(measured[r["key"]]) if r["key"] in measured else None
        share = f"{floor / meas:6.3f}" if meas else "   n/a"
        print(f"{r['name']:28s} {r['bytes'] / 1e9:8.2f} "
              f"{r['flops'] / 1e9:7.0f} {t_bw:6.2f} {t_fl:6.2f} "
              f"{floor:6.2f} {meas if meas else float('nan'):7.2f} {share} "
              f"{'memory' if t_bw > t_fl else 'f32 FLOP/s'}")
    print("\nms per step; share = floor / measured, against the published "
          "peaks of", args.kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
