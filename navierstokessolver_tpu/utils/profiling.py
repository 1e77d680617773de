"""Reduce a ``jax.profiler`` trace to device time per projection phase.

Every phase of the step runs under a ``jax.named_scope`` (solver.py:
bcs / predictor / poisson / correction / diagnostics, plus
``refine_residual`` inside the direct spectral solve). XLA keeps the scope
path in each instruction's ``op_name`` metadata, and the profiler tags
every device event with the ``hlo_op`` it ran. So the reduction maps
event -> instruction (the compiled module's HLO text) -> innermost scope.
Inside a GPU command buffer (CUDA graph) every kernel reports
``hlo_op=command_buffer``; fusion kernels are then matched by kernel name
(the instruction name with ``.`` -> ``_``), so trace a program compiled
with command buffers off for a complete attribution.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterable, Optional

# Published peaks per device kind (NVIDIA H100 SXM data sheet, dense, at
# the full 700 W power limit): bytes/s of HBM and FLOP/s per arithmetic.
# A device that is not listed is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_s=3.35e12, f32_flops=67e12,
                                  tf32_flops=495e12, bf16_flops=989e12),
}


def device_peaks(kind: str) -> dict:
    """The published peaks of ``kind`` (``jax.devices()[0].device_kind``)."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


# innermost-first: a refinement residual inside "poisson" counts as
# "refine_residual", everything else under "poisson" as "poisson"
SCOPES = ("refine_residual", "bcs", "predictor", "predictor2", "ibm",
          "poisson", "correction", "scalar", "diagnostics")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?"
                    r"metadata=\{[^}]*op_name=\"([^\"]*)\"")


def hlo_scopes(hlo_text: str, scopes: Iterable[str] = SCOPES) -> dict:
    """{instruction name: scope} from compiled HLO text (``as_text()``).
    Instructions under no known scope are left out."""
    scopes = tuple(scopes)
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        for s in scopes:
            if s in parts:
                out[m.group(1)] = s
                break
    return out


def find_xplane(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return files[-1]


def _union_ns(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def scope_device_times(trace_dir: str, hlo_text: str,
                       plane_prefix: str = "/device:GPU",
                       module: Optional[str] = None,
                       unmatched: Optional[dict] = None) -> dict:
    """Seconds of device time per scope over the traced window.

    Sums the durations of every event that carries an ``hlo_op`` stat on
    the planes whose name starts with ``plane_prefix`` (optionally only
    events of the HLO module ``module``). Returns ``{scope: seconds}``
    plus ``"other"`` (events under no known scope), ``"total"`` (the sum)
    and ``"busy"`` / ``"window"`` (union of event intervals and first-to-
    last event span, per plane, summed over planes). ``unmatched``, when
    given, collects the seconds of each event name counted as "other"."""
    from jax.profiler import ProfileData

    name_to_scope = hlo_scopes(hlo_text)
    kernel_to_scope = {k.replace(".", "_").replace("-", "_"): v
                       for k, v in name_to_scope.items()}
    pd = ProfileData.from_file(find_xplane(trace_dir))
    out: dict = {}
    busy = window = 0.0
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        intervals = []
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                if module is not None and stats.get("hlo_module") != module:
                    continue
                dur = float(ev.duration_ns)
                key = name_to_scope.get(str(op))
                if key is None:
                    key = kernel_to_scope.get(ev.name, "other")
                if key == "other" and unmatched is not None:
                    unmatched[ev.name] = unmatched.get(ev.name, 0.0) \
                        + dur * 1e-9
                out[key] = out.get(key, 0.0) + dur * 1e-9
                intervals.append((float(ev.start_ns),
                                  float(ev.start_ns) + dur))
        if intervals:
            busy += _union_ns(intervals) * 1e-9
            window += (max(e for _, e in intervals)
                       - min(s for s, _ in intervals)) * 1e-9
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["busy"] = busy
    out["window"] = window
    return out
