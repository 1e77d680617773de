"""Command-line driver (SURVEY.md SS2 "Config/CLI" row; layer L7).

Runs a registered case end-to-end: chunked jit-scanned stepping with
structured window logs, async snapshot streaming, periodic checkpoints and
``--resume``.

Examples:
  python -m navierstokessolver_tpu.cli --case cavity --steps 2000
  python -m navierstokessolver_tpu.cli --case cylinder --steps 20000 \
      --snapshot-every 500 --out out/cyl --vtk
  python -m navierstokessolver_tpu.cli --case cavity --resume out/cavity/ckpt.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_shape(s):
    return tuple(int(x) for x in s.split(",")) if s else None


def load_config_file(path: str) -> dict:
    """Case overrides from a JSON (or YAML, if pyyaml is present) file:
    a flat mapping of case-builder kwargs plus the optional reserved keys
    ``case`` and ``steps``. CLI flags take precedence over file values."""
    import json

    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # optional dependency
        except ImportError as e:
            raise RuntimeError(
                "YAML config requires pyyaml; use JSON instead"
            ) from e
        cfg = yaml.safe_load(text)
    else:
        cfg = json.loads(text)
    if not isinstance(cfg, dict):
        raise ValueError(f"config file {path} must hold a mapping")
    if "shape" in cfg:
        cfg["shape"] = tuple(cfg["shape"])
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="navierstokessolver_tpu")
    ap.add_argument("--config", default=None,
                    help="JSON/YAML file of case-builder overrides "
                         "(reserved keys: case, steps); CLI flags win")
    ap.add_argument("--case", default=None, help="default: cavity")
    ap.add_argument("--shape", type=parse_shape, default=None,
                    help="grid cells per axis, e.g. 128,128")
    ap.add_argument("--re", type=float, default=None)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="default: the case's suggested step count")
    ap.add_argument("--poisson", default=None,
                    help="jacobi | gs | sor | cg | mg | mgcg | fft | dctcg")
    ap.add_argument("--poisson-tol", type=float, default=None)
    ap.add_argument("--upwind-gamma", type=float, default=None)
    ap.add_argument("--ibm", action="store_true",
                    help="sharp-interface immersed boundary for obstacle "
                         "cases (direct forcing; cylinder/sphere)")
    ap.add_argument("--spin", type=float, default=0.0,
                    help="rotation rate alpha = omega R / U for the "
                         "cylinder/sphere cases (requires --ibm): the "
                         "rotating-body/Magnus configuration")
    ap.add_argument("--sharp-pressure", action="store_true",
                    help="cut-cell apertured Poisson (cutcell.py): the "
                         "pressure side of the sharp interface; requires "
                         "--ibm and an iterative/mg --poisson")
    ap.add_argument("--les-cs", type=float, default=None,
                    help="enable the Smagorinsky LES closure with this "
                         "constant (0.1-0.2 typical; see les.py); any case")
    ap.add_argument("--les-model", default=None,
                    choices=["smagorinsky", "dynamic"],
                    help="LES variant: static-cs smagorinsky or the "
                         "Germano-Lilly dynamic model (self-calibrating; "
                         "--les-cs then unused). Enables LES by itself.")
    ap.add_argument("--integrator", default=None, choices=["euler", "rk2"],
                    help="time integrator (default: euler)")
    ap.add_argument("--chunk", type=int, default=200,
                    help="steps per jitted scan chunk / logging window")
    ap.add_argument("--out", default=None, help="output directory")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="steps between snapshots (0 = off)")
    ap.add_argument("--vtk", action="store_true",
                    help="also write legacy VTK files for ParaView")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint path")
    ap.add_argument("--csv", default=None, help="CSV metrics path")
    ap.add_argument("--forces-box", default=None,
                    help="2*ndim cell indices (i0,i1,j0,j1[,k0,k1]): sample "
                         "control-volume drag/lift terms each window into "
                         "forces.csv (see utils/forces.py)")
    ap.add_argument("--tracers", type=int, default=0,
                    help="advect N Lagrangian tracer particles in-scan and "
                         "write their trajectories to tracers.npz")
    ap.add_argument("--tracer-seed", type=int, default=0)
    ap.add_argument("--stats-start", type=int, default=-1,
                    help="accumulate running statistics (time-mean fields + "
                         "Reynolds stresses) from this step on, written to "
                         "<out>/stats.npz (-1 = off; see stats.py)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard over the first N devices (0 = single device)")
    ap.add_argument("--poisson-comm", default="gspmd",
                    choices=["gspmd", "halo"],
                    help="distributed pressure solve: GSPMD auto-collectives "
                         "or the explicit shard_map+ppermute halo ring")
    ap.add_argument("--platform", default=None,
                    help="force the jax platform (e.g. cpu, gpu); set "
                         "before first backend use")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import jax
    import numpy as np

    from . import io as io_mod
    from .cases import make_case
    from .utils.metrics import StepLogger, WindowStats

    file_cfg = load_config_file(args.config) if args.config else {}
    file_case = file_cfg.pop("case", None)  # always pop: reserved key, and
    case_name = args.case or file_case or "cavity"  # --case wins over it
    file_steps = file_cfg.pop("steps", None)

    overrides = dict(file_cfg)
    if args.shape is not None:
        overrides["shape"] = args.shape
    if args.re is not None:
        overrides["re"] = args.re
    if args.dt is not None:
        overrides["dt"] = args.dt
    if args.poisson is not None:
        overrides["poisson_method"] = args.poisson
    if args.poisson_tol is not None:
        overrides["poisson_tol"] = args.poisson_tol
    if args.integrator is not None:
        overrides["integrator"] = args.integrator
    if args.upwind_gamma is not None:
        overrides["upwind_gamma"] = args.upwind_gamma
    if args.ibm:
        overrides["ibm"] = True
    if args.spin:
        overrides["spin"] = args.spin
    if args.sharp_pressure:
        overrides["sharp_pressure"] = True

    case = make_case(case_name, **overrides)
    sim = case.sim
    if args.les_cs or args.les_model:
        import dataclasses as _dc

        from .les import LESConfig

        sim = _dc.replace(sim, les=LESConfig(
            cs=args.les_cs or 0.17,
            model=args.les_model or "smagorinsky",
        ))
    n_steps = (args.steps if args.steps is not None else
               file_steps if file_steps is not None else
               case.suggested_steps)
    out_dir = args.out or os.path.join("out", case_name)
    os.makedirs(out_dir, exist_ok=True)

    if args.devices > 1:
        from .parallel import make_mesh, shard_state, sharded_simulation

        mesh = make_mesh(args.devices)
        sim = sharded_simulation(sim, mesh, poisson_comm=args.poisson_comm)

    cfg_hash = io_mod.config_hash(sim.grid, sim.params, sim.scalar, sim.les,
                                  ibm=sim.ibm is not None,
                                  sharp_pressure=sim.op.ap is not None)
    step0 = 0
    state = case.initial_state()
    if args.resume:
        state, step0 = io_mod.load_checkpoint(
            args.resume, sim.grid, cfg_hash,
            expect_scalar=sim.scalar is not None,
        )
        print(f"[cli] resumed from {args.resume} at step {step0}", file=sys.stderr)
        if sim.params.poisson.extrapolate and state.p_prev is None:
            # older checkpoint without the extrapolation carry: backfill
            # (first resumed step then warm-starts from p instead of 2p-p_prev)
            from .grid import State as _State

            state = _State(u=state.u, p=state.p, theta=state.theta,
                           p_prev=state.p)
    if args.devices > 1:
        state = shard_state(state, mesh, sim.grid)

    logger = StepLogger(csv_path=args.csv)
    writer = None
    if args.snapshot_every > 0:
        writer = io_mod.AsyncSnapshotWriter(out_dir, sim.grid, vtk=args.vtk)

    print(
        f"[cli] case={case_name} grid={sim.grid.shape} dt={sim.params.dt:.3e} "
        f"nu={sim.params.nu:.3e} poisson={sim.params.poisson.method} "
        f"steps={n_steps} device={jax.devices()[0].device_kind}",
        file=sys.stderr,
    )

    forces_box = None
    forces_rows = []
    if args.forces_box:
        forces_box = tuple(int(x) for x in args.forces_box.split(","))
        if len(forces_box) != 2 * sim.grid.ndim:
            print(f"[cli] --forces-box needs {2 * sim.grid.ndim} indices "
                  f"for a {sim.grid.ndim}D grid; ignoring", file=sys.stderr)
            forces_box = None

    step = step0
    next_snap = step + args.snapshot_every if args.snapshot_every else None
    stats_start = args.stats_start if args.stats_start >= 0 else None
    stats = None
    if args.resume:
        # Stats stored in the checkpoint resume UNCONDITIONALLY (not gated
        # on --stats-start): accumulation was already underway, and the
        # next periodic checkpoint write would otherwise overwrite them
        # with stats=None, destroying the run's accumulated averages.
        stats = io_mod.load_checkpoint_stats(args.resume, sim.grid.dtype)
        if stats is not None:
            print(f"[cli] resumed statistics ({int(np.asarray(stats.n))} "
                  "samples)", file=sys.stderr)
            stats_start = (step0 if stats_start is None
                           else min(stats_start, step0))
    tracer_pos = None
    tracer_traj = []
    if args.tracers:
        if stats_start is not None:
            print("[cli] --tracers and --stats-start are mutually exclusive "
                  "(one scan carry each); ignoring --tracers", file=sys.stderr)
        else:
            from . import tracers as tracers_mod

            if args.resume:
                tracer_pos = io_mod.load_checkpoint_tracers(
                    args.resume, sim.grid.dtype
                )
                if tracer_pos is not None:
                    print(f"[cli] resumed {tracer_pos.shape[0]} tracers",
                          file=sys.stderr)
            if tracer_pos is None:
                tracer_pos = tracers_mod.seed_tracers(
                    sim.grid, args.tracers, args.tracer_seed
                )
    try:
        while step < step0 + n_steps:
            chunk = min(args.chunk, step0 + n_steps - step)
            # Snapshot cadence is decoupled from the scan-chunk/window size:
            # the window is split into scan segments that land exactly on
            # snapshot steps (scan(a) then scan(b) is bitwise scan(a+b), so
            # enabling snapshots is trajectory-neutral -- tested in
            # tests/test_io.py). Each enqueue hands the still-on-device
            # arrays to the writer thread without blocking the next segment.
            # --stats-start is one more segmentation point: segments at or
            # past it run through run_scan_stats (accumulator in the carry).
            t0 = time.perf_counter()
            diags = []
            done = 0
            while done < chunk:
                seg = chunk - done
                if next_snap is not None:
                    seg = min(seg, next_snap - step)
                if stats_start is not None and step < stats_start:
                    seg = min(seg, stats_start - step)
                if stats_start is not None and step >= stats_start:
                    state, diag, stats = sim.run_scan_stats(state, seg, stats)
                elif tracer_pos is not None:
                    state, tracer_pos, diag, traj = sim.run_scan_tracers(
                        state, tracer_pos, seg
                    )
                    tracer_traj.append(np.asarray(traj))
                else:
                    state, diag = sim.run_scan(state, seg)
                diags.append(diag)
                step += seg
                done += seg
                if writer is not None and step == next_snap:
                    writer.enqueue(state, step, step * sim.params.dt)
                if next_snap is not None and step >= next_snap:
                    next_snap += args.snapshot_every
            jax.block_until_ready(state.p)
            wall = time.perf_counter() - t0
            diag = jax.tree.map(
                lambda *xs: np.concatenate([np.asarray(x) for x in xs]), *diags
            ) if len(diags) > 1 else diags[0]
            logger.log(WindowStats.from_diag(
                diag, step=step, dt=sim.params.dt, wall_s=wall,
                n_cells=sim.grid.num_cells(),
            ))
            if forces_box is not None:
                from .utils.forces import cv_terms_nd

                sf, mom = cv_terms_nd(
                    sim.grid, state, sim.params.nu, forces_box
                )
                forces_rows.append(
                    (step, *(float(x) for x in sf),
                     *(float(x) for x in mom))
                )
            if args.checkpoint_every and step % args.checkpoint_every < chunk:
                io_mod.save_checkpoint(
                    os.path.join(out_dir, "ckpt.npz"), state, step, cfg_hash,
                    stats=stats, tracers=tracer_pos,
                )
    finally:
        if writer is not None:
            writer.close()
    if args.checkpoint_every:
        io_mod.save_checkpoint(
            os.path.join(out_dir, "ckpt.npz"), state, step, cfg_hash,
            stats=stats, tracers=tracer_pos,
        )
    if stats is not None:
        from . import stats as stats_mod

        path = os.path.join(out_dir, "stats.npz")
        np.savez_compressed(path, **stats_mod.finalize(stats))
        print(f"[cli] wrote {path} ({int(np.asarray(stats.n))} samples)",
              file=sys.stderr)
    if tracer_traj:
        path = os.path.join(out_dir, "tracers.npz")
        np.savez_compressed(
            path,
            traj=np.concatenate(tracer_traj, axis=0),
            final=np.asarray(tracer_pos),
        )
        print(f"[cli] wrote {path} ({sum(t.shape[0] for t in tracer_traj)} "
              f"steps x {args.tracers} tracers)", file=sys.stderr)
    if forces_rows:
        import csv

        path = os.path.join(out_dir, "forces.csv")
        axes = "xyz"[: sim.grid.ndim]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step"] + [f"sf_{a}" for a in axes]
                       + [f"mom_{a}" for a in axes])
            w.writerows(forces_rows)
        print(f"[cli] wrote {path} ({len(forces_rows)} samples); assemble "
              "Cd/Cl with utils.forces.drag_lift_series", file=sys.stderr)
    print(f"[cli] done at step {step}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
