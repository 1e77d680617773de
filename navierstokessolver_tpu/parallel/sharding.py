"""Domain decomposition over a device mesh (SURVEY.md SS2 "Parallelism" row).

The reference is single-process; distribution is new scope: multi-device
runs shard the grid via domain decomposition with halo exchange. Mechanism:
annotate the grid axes with ``jax.sharding.NamedSharding`` and let XLA's
SPMD partitioner insert the halo exchanges (collective-permutes, which XLA
hands to NCCL on GPUs) for every stencil, and ``psum`` for the global
reductions inside the Poisson ``while_loop``. The explicit alternative is
parallel/halo.py (shard_map + ppermute/psum/all_to_all).

The spatial mesh axes are named ``sx, sy, sz`` -- the CFD analog of
sequence/context parallelism (SURVEY.md SS5 "long-context" note): the grid is
the sequence, the halo exchange is the ring.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid import GridSpec, State

SPATIAL_AXES = ("sx", "sy", "sz")


def make_mesh(
    mesh_shape: Sequence[int] | int,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a spatial device mesh; ``mesh_shape`` per grid axis (or 1D int).

    Example: ``make_mesh(8)`` -> 1D decomposition of the leading grid axis;
    ``make_mesh((2, 4))`` -> 2D pencil decomposition.
    """
    if isinstance(mesh_shape, int):
        mesh_shape = (mesh_shape,)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    ndev = int(np.prod(mesh_shape))
    devices = list(devices if devices is not None else jax.devices())[:ndev]
    if len(devices) < ndev:
        raise ValueError(
            f"mesh {mesh_shape} needs {ndev} devices, have {len(devices)}"
        )
    arr = np.asarray(devices).reshape(mesh_shape)
    return Mesh(arr, SPATIAL_AXES[: len(mesh_shape)])


def state_shardings(mesh: Mesh, grid: GridSpec) -> State:
    """A State-shaped pytree of NamedShardings: grid axis i -> mesh axis i.

    All fields (u components and p) share the same spatial partitioning; the
    +1 staggering along a component's own axis is handled by GSPMD's uneven
    (padded) partitioning. Use these as ``with_sharding_constraint`` targets
    inside jit (``Simulation.shardings``); ``device_put`` rejects uneven dims,
    so initial placement goes through :func:`shard_state` instead.
    """
    names = list(mesh.axis_names) + [None] * (grid.ndim - len(mesh.axis_names))
    spec = P(*names[: grid.ndim])
    sh = NamedSharding(mesh, spec)
    return State(u=tuple(sh for _ in range(grid.ndim)), p=sh)


def _divisible_spec(mesh: Mesh, grid: GridSpec, shape) -> NamedSharding:
    """Like state_shardings but drops mesh axes that don't divide the dim
    (device_put requires exact divisibility; the step constraint re-lays-out)."""
    names = list(mesh.axis_names) + [None] * (grid.ndim - len(mesh.axis_names))
    names = names[: grid.ndim]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    spec = [
        n if (n is not None and shape[i] % sizes[n] == 0) else None
        for i, n in enumerate(names)
    ]
    return NamedSharding(mesh, P(*spec))


def shard_state(state: State, mesh: Mesh, grid: GridSpec) -> State:
    """Place a state onto the mesh with domain-decomposed sharding.

    Staggered axes (n+1 faces) are left unsplit at placement time; the
    in-step sharding constraint moves them to the true decomposition on the
    first step.
    """
    shardings = State(
        u=tuple(
            _divisible_spec(mesh, grid, c.shape) for c in state.u
        ),
        p=_divisible_spec(mesh, grid, state.p.shape),
        theta=(None if state.theta is None
               else _divisible_spec(mesh, grid, state.theta.shape)),
        p_prev=(None if state.p_prev is None
                else _divisible_spec(mesh, grid, state.p_prev.shape)),
        t=(None if state.t is None else NamedSharding(mesh, P())),
    )
    return jax.device_put(state, shardings)


def sharded_simulation(sim, mesh: Mesh, poisson_comm: str = "gspmd"):
    """Return a copy of ``sim`` whose step constrains fields to the mesh.

    ``poisson_comm`` selects the distributed pressure-solve mechanism:
      * ``"gspmd"`` (default): XLA's SPMD partitioner inserts the halo
        collectives for every stencil in the Poisson while_loop;
      * ``"halo"``: the explicit shard_map + ppermute solver
        (parallel/halo.py) -- hand-written ring halos + psum reductions,
        same convergence semantics (one shared implementation).
        Requires an iterative method (jacobi/gs/sor/cg/mg/mgcg; the
        multigrid V-cycle runs fine levels block-local with ppermute
        ghosts and gathers the tiny coarse levels).
    """
    import dataclasses

    halo_solver = None
    if poisson_comm == "halo":
        from .halo import ShardedPoissonSolver

        halo_solver = ShardedPoissonSolver.build(
            sim.grid, sim.op, mesh, sim.params.poisson, mg=sim.mg_solver,
            dctcg=sim.dctcg_solver,
        )
    elif poisson_comm != "gspmd":
        raise ValueError(f"unknown poisson_comm {poisson_comm!r}")
    return dataclasses.replace(
        sim,
        shardings=state_shardings(mesh, sim.grid),
        halo_solver=halo_solver,
    )


def replicate_state(state: State, mesh: Mesh) -> State:
    sh = NamedSharding(mesh, P())
    return jax.device_put(state, sh)
