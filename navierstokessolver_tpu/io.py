"""Snapshot, checkpoint and async host-streaming I/O.

Capability parity: the reference's periodic field dumps for visualization
(SURVEY.md SS2 "Snapshot I/O", SS3.3) plus checkpoint/resume (SURVEY.md SS5).
Design: the step loop never blocks on disk -- snapshots are
enqueued as device arrays and a host writer thread performs the
device->host copy and serialization concurrently with the next `run_scan`
chunk (dispatch-ahead; BASELINE.json north star "without stalling the step
loop").

Formats:
  * snapshots: ``.npz`` (fields + metadata) and optional legacy-ASCII
    ``.vtk`` structured-points files for ParaView.
  * checkpoints: ``.npz`` with the full State, step counter and a config
    hash; ``load_checkpoint`` refuses mismatched configs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import threading
from typing import Optional

import jax
import numpy as np

from .grid import GridSpec, State, interpolate_to_centers
from .ops.stencils import (
    q_criterion_3d,
    streamfunction_2d,
    vorticity_2d,
    vorticity_magnitude_3d,
)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------


def snapshot_arrays(grid: GridSpec, state: State) -> dict[str, np.ndarray]:
    """Assemble host-side arrays for a snapshot (cell-centered velocity,
    pressure, vorticity in 2D)."""
    out: dict[str, np.ndarray] = {}
    centered = interpolate_to_centers(grid, state.u)
    for a, c in enumerate(centered):
        out[f"u{'xyz'[a]}"] = np.asarray(c)
    out["p"] = np.asarray(state.p)
    for a, c in enumerate(state.u):
        out[f"u{'xyz'[a]}_face"] = np.asarray(c)
    if state.theta is not None:
        out["theta"] = np.asarray(state.theta)
    if grid.ndim == 2:
        out["vorticity"] = np.asarray(vorticity_2d(grid, state.u))
        out["streamfunction"] = np.asarray(streamfunction_2d(grid, state.u))
    else:
        out["vorticity_mag"] = np.asarray(
            vorticity_magnitude_3d(grid, state.u)
        )
        out["q_criterion"] = np.asarray(q_criterion_3d(grid, state.u))
    return out


def write_snapshot(
    path: str,
    grid: GridSpec,
    state: State,
    step: int,
    time: float,
    vtk: bool = False,
) -> None:
    arrays = snapshot_arrays(grid, state)
    meta = dict(
        step=int(step),
        time=float(time),
        shape=list(grid.shape),
        lengths=list(grid.lengths),
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    if vtk:
        write_vtk(os.path.splitext(path)[0] + ".vtk", grid, arrays, meta)


def write_vtk(path: str, grid: GridSpec, arrays: dict, meta: dict) -> None:
    """Legacy VTK structured-points file, ParaView-ready.

    Uses the native C++ binary codec (navierstokessolver_tpu.native) when the
    toolchain is available -- big-endian conversion + Fortran-order gather in
    native code; falls back to the portable ASCII writer below.
    """
    nd = grid.ndim
    try:
        from . import native

        scalars = {"pressure": arrays["p"]}
        if "vorticity" in arrays and nd == 2:
            w = arrays["vorticity"]
            wp = np.zeros(grid.shape, w.dtype)
            wp[:-1, :-1] = w
            scalars["vorticity"] = wp
        ok = native.write_vtk_binary(
            path,
            grid.shape,
            grid.spacing,
            [arrays[f"u{'xyz'[a]}"] for a in range(nd)],
            scalars,
            f"navierstokessolver_tpu step={meta['step']} t={meta['time']}",
        )
        if ok:
            return
    except Exception:
        pass  # fall through to the ASCII writer
    dims = list(grid.shape) + [1] * (3 - nd)
    sp = list(grid.spacing) + [1.0] * (3 - nd)
    n = int(np.prod(grid.shape))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"navierstokessolver_tpu step={meta['step']} t={meta['time']}\n")
        f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write("ORIGIN 0 0 0\n")
        f.write(f"SPACING {sp[0]} {sp[1]} {sp[2]}\n")
        f.write(f"POINT_DATA {n}\n")
        comps = [arrays.get(f"u{'xyz'[a]}") for a in range(nd)]
        f.write("VECTORS velocity float\n")
        flat = [c.reshape(-1, order="F") for c in comps]
        zeros = np.zeros_like(flat[0])
        while len(flat) < 3:
            flat.append(zeros)
        for row in zip(*flat):
            f.write(f"{row[0]:.6g} {row[1]:.6g} {row[2]:.6g}\n")
        f.write("SCALARS pressure float 1\nLOOKUP_TABLE default\n")
        for v in arrays["p"].reshape(-1, order="F"):
            f.write(f"{v:.6g}\n")
        if "vorticity" in arrays and nd == 2:
            w = arrays["vorticity"]
            wp = np.zeros(grid.shape, w.dtype)
            wp[:-1, :-1] = w  # node -> cell (drop last row/col)
            f.write("SCALARS vorticity float 1\nLOOKUP_TABLE default\n")
            for v in wp.reshape(-1, order="F"):
                f.write(f"{v:.6g}\n")


class AsyncSnapshotWriter:
    """Background writer: the sim thread enqueues on-device states; this
    thread pulls them to host and serializes, overlapping with compute."""

    def __init__(self, out_dir: str, grid: GridSpec, vtk: bool = False,
                 max_pending: int = 4):
        self.out_dir = out_dir
        self.grid = grid
        self.vtk = vtk
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def enqueue(self, state: State, step: int, time: float) -> None:
        if self._err is not None:
            raise RuntimeError("snapshot writer failed") from self._err
        # Keep the arrays on device; the writer thread does the host copy.
        self._q.put((state, int(step), float(time)))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            state, step, time = item
            try:
                path = os.path.join(self.out_dir, f"snap_{step:08d}.npz")
                write_snapshot(path, self.grid, state, step, time, self.vtk)
            except BaseException as e:  # surfaced on next enqueue/close
                self._err = e
                return

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise RuntimeError("snapshot writer failed") from self._err


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _scalar_blob(scalar) -> Optional[dict]:
    """JSON-able digest of a ScalarConfig (physics-affecting fields only).

    theta_init is deliberately excluded: it shapes the *initial* state, not
    the resumed dynamics (the checkpointed theta supersedes it).
    """
    if scalar is None:
        return None

    def bcval(v):
        arr = np.asarray(v)
        if arr.ndim == 0:
            return float(arr)
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]

    blob = dict(
        diffusivity=scalar.diffusivity,
        buoyancy=list(scalar.buoyancy),
        theta_ref=scalar.theta_ref,
        upwind_gamma=scalar.upwind_gamma,
        bcs={
            f"{a},{s}": [bc.kind.value, bcval(bc.value)]
            for (a, s), bc in sorted(scalar.bcs.items())
        },
    )
    # Omitted (not None-valued) when unset, so hashes of checkpoints
    # written before body scalar BCs existed stay valid (ADVICE r3).
    if getattr(scalar, "body_bc", None) is not None:
        blob["body_bc"] = [scalar.body_bc.kind.value,
                           bcval(scalar.body_bc.value)]
    return blob


def config_hash(grid: GridSpec, params, scalar=None, les=None,
                ibm=False, sharp_pressure=False) -> str:
    d = dict(
        shape=list(grid.shape),
        lengths=list(grid.lengths),
        dtype=str(np.dtype(grid.dtype)) if grid.dtype else "float32",
        dt=params.dt,
        nu=params.nu,
        rho=params.rho,
        upwind_gamma=params.upwind_gamma,
        integrator=params.integrator,
        poisson=dataclasses.asdict(params.poisson),
        scalar=_scalar_blob(scalar),
        # physics-affecting closure config (a checkpoint from an LES
        # run must not resume silently as a no-model run)
        les=None if les is None else dataclasses.asdict(les),
        # sharp-interface IBM changes the boundary physics too
        ibm=bool(ibm),
    )
    # The cut-cell apertured pressure operator changes the boundary
    # physics too -- but the key is included only when SET, so hashes of
    # checkpoints written before the feature existed stay valid
    # (ADVICE r3: unconditional embedding invalidated every legacy
    # checkpoint, including runs that use none of the new features).
    if sharp_pressure:
        d["sharp_pressure"] = True
    blob = json.dumps(d, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def save_checkpoint(
    path: str, state: State, step: int, cfg_hash: str, stats=None,
    tracers=None,
) -> None:
    """``stats`` (optional FlowStats): running statistics are part of the
    restartable state of a long averaging run; they ride along under
    ``stats_*`` keys (see :func:`load_checkpoint_stats`). ``tracers``
    (optional (n, nd) positions): Lagrangian particles resume where they
    were (see :func:`load_checkpoint_tracers`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"u{a}": np.asarray(c) for a, c in enumerate(state.u)}
    arrays["p"] = np.asarray(state.p)
    if state.theta is not None:
        arrays["theta"] = np.asarray(state.theta)
    if state.p_prev is not None:
        arrays["p_prev"] = np.asarray(state.p_prev)
    if state.t is not None:
        arrays["t"] = np.asarray(state.t)
    if stats is not None:
        from . import stats as stats_mod

        arrays.update({
            f"stats_{k}": v for k, v in stats_mod.to_arrays(stats).items()
        })
    if tracers is not None:
        arrays["tracer_pos"] = np.asarray(tracers)
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.int64(step), cfg=np.bytes_(cfg_hash.encode()), **arrays)
    os.replace(tmp, path)


def load_checkpoint_tracers(path: str, dtype):
    """Tracer positions saved alongside a checkpoint, or None."""
    with np.load(path) as z:
        if "tracer_pos" not in z.files:
            return None
        return jax.numpy.asarray(z["tracer_pos"], dtype)


def load_checkpoint_stats(path: str, dtype):
    """The FlowStats accumulator saved alongside a checkpoint, or None if
    the checkpoint predates / didn't collect statistics."""
    from . import stats as stats_mod

    with np.load(path) as z:
        d = {k[len("stats_"):]: z[k] for k in z.files
             if k.startswith("stats_")}
    return stats_mod.from_arrays(d, dtype) if d else None


def load_checkpoint(
    path: str,
    grid: GridSpec,
    cfg_hash: Optional[str] = None,
    expect_scalar: bool = False,
):
    """Returns (state, step). Raises on config-hash mismatch when given.

    ``expect_scalar=True`` (pass when the resuming Simulation has a scalar
    configured) makes a theta-less checkpoint a hard error instead of a
    silent physics change (the step loop would quietly skip scalar
    transport + buoyancy on theta=None).
    """
    with np.load(path) as z:
        saved = bytes(z["cfg"]).decode()
        if cfg_hash is not None and saved != cfg_hash:
            raise ValueError(
                f"checkpoint config hash {saved} != current {cfg_hash}; "
                "refusing to resume a different configuration"
            )
        if expect_scalar and "theta" not in z.files:
            raise ValueError(
                "simulation has a transported scalar configured but the "
                f"checkpoint {path!r} has no theta field; refusing to resume "
                "with silently-disabled scalar transport"
            )
        u = tuple(
            jax.numpy.asarray(z[f"u{a}"], grid.dtype) for a in range(grid.ndim)
        )
        p = jax.numpy.asarray(z["p"], grid.dtype)
        theta = (jax.numpy.asarray(z["theta"], grid.dtype)
                 if "theta" in z.files else None)
        p_prev = (jax.numpy.asarray(z["p_prev"], grid.dtype)
                  if "p_prev" in z.files else None)
        t = (jax.numpy.asarray(z["t"], grid.dtype)
             if "t" in z.files else None)
        step = int(z["step"])
    return State(u=u, p=p, theta=theta, p_prev=p_prev, t=t), step
