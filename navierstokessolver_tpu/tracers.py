"""Lagrangian particle tracers: MAC-aware interpolation + in-scan advection.

Passive flow tracers (visualization / transport diagnostics) advected with
the resolved velocity field. Capability extension beyond the reference
scope (the reference mount was empty -- SURVEY.md SS0): tracers are the
standard companion feature of any production solver's snapshot pipeline.

Design: particle positions live on device as one ``(n, nd)``
array; interpolation is a fully vectorized 2^nd-corner gather (XLA lowers
it to a batched dynamic-gather, no host loops), and the RK2 advection rides
inside the same jitted ``lax.scan`` as the flow step
(:meth:`solver.Simulation.run_scan_tracers`), so tracking a million
particles adds zero host round-trips.

Interpolation respects the MAC staggering: component ``a`` is sampled on
its face lattice (integer coordinates along axis ``a``, cell centers on the
transverse axes) with multilinear weights. Boundary closure per axis:
periodic axes wrap (the duplicate face row makes the face-axis gather
seam-free); wall/in-out axes clamp to the outermost sample (constant
extrapolation across the final half cell -- adequate for passive tracers;
no-slip walls still attract a clamped tracer's velocity to the wall value
as it crosses the last face row).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import jax
import jax.numpy as jnp

from .bcs import BCTable, periodic_axes
from .grid import GridSpec

Array = jax.Array


def _face_axis_weights(x: Array, h: float, n_cells: int):
    """Weights along a component's own (face) axis: samples at i*h,
    i = 0..n_cells (the duplicate wrap face included for periodic axes, so
    clamping covers both closures)."""
    s = x / h
    i0 = jnp.clip(jnp.floor(s), 0, n_cells - 1).astype(jnp.int32)
    w = jnp.clip(s - i0, 0.0, 1.0)
    return i0, i0 + 1, w


def _center_axis_weights(x: Array, h: float, n_cells: int, wrap: bool):
    """Weights along a transverse (cell-center) axis: samples at
    (i + 0.5)*h. Periodic: wrap indices; otherwise clamp."""
    s = x / h - 0.5
    if wrap:
        base = jnp.floor(s)
        w = s - base
        i0 = jnp.mod(base.astype(jnp.int32), n_cells)
        i1 = jnp.mod(i0 + 1, n_cells)
    else:
        i0 = jnp.clip(jnp.floor(s), 0, n_cells - 2).astype(jnp.int32)
        w = jnp.clip(s - i0, 0.0, 1.0)
        i1 = i0 + 1
    return i0, i1, w


def velocity_at(
    grid: GridSpec, bcs: BCTable, u: Sequence[Array], pos: Array
) -> Array:
    """Multilinear MAC interpolation of the velocity at ``pos`` (n, nd).

    Exact for fields that are (multi)linear in the coordinates -- the
    tests pin uniform and pure-shear fields to roundoff.
    """
    nd = grid.ndim
    h = grid.spacing
    per = periodic_axes(grid, bcs)
    out = []
    for a in range(nd):
        idx0, idx1, ws = [], [], []
        for ax in range(nd):
            x = pos[:, ax]
            if ax == a:
                i0, i1, w = _face_axis_weights(x, h[ax], grid.shape[ax])
            else:
                i0, i1, w = _center_axis_weights(
                    x, h[ax], grid.shape[ax], per[ax]
                )
            idx0.append(i0)
            idx1.append(i1)
            ws.append(w)
        val = jnp.zeros(pos.shape[0], grid.dtype)
        for corner in itertools.product((0, 1), repeat=nd):
            idx = tuple(idx1[ax] if c else idx0[ax]
                        for ax, c in enumerate(corner))
            wgt = jnp.ones(pos.shape[0], grid.dtype)
            for ax, c in enumerate(corner):
                wgt = wgt * (ws[ax] if c else (1.0 - ws[ax]))
            val = val + wgt * u[a][idx]
        out.append(val)
    return jnp.stack(out, axis=1)


def confine(grid: GridSpec, bcs: BCTable, pos: Array) -> Array:
    """Keep tracers in the domain: wrap periodic axes, clamp the rest."""
    per = periodic_axes(grid, bcs)
    cols = []
    for ax in range(grid.ndim):
        L = grid.lengths[ax]
        x = pos[:, ax]
        cols.append(jnp.mod(x, L) if per[ax] else jnp.clip(x, 0.0, L))
    return jnp.stack(cols, axis=1)


def advect_tracers(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[Array],
    pos: Array,
    dt,
    integrator: str = "rk2",
) -> Array:
    """One explicit advection step of the tracer positions.

    ``rk2`` (midpoint, default) matches the flow solver's temporal order;
    ``euler`` is available for exactness tests on constant fields.
    """
    v1 = velocity_at(grid, bcs, u, pos)
    if integrator == "euler":
        return confine(grid, bcs, pos + dt * v1)
    mid = confine(grid, bcs, pos + (0.5 * dt) * v1)
    v2 = velocity_at(grid, bcs, u, mid)
    return confine(grid, bcs, pos + dt * v2)


def seed_tracers(
    grid: GridSpec, n: int, seed: int = 0, margin: float = 0.05
) -> Array:
    """``n`` deterministic uniform-random positions, inset by ``margin``
    (fraction of each extent) from non-periodic boundaries."""
    key = jax.random.PRNGKey(seed)
    unit = jax.random.uniform(key, (n, grid.ndim), dtype=grid.dtype)
    lo = jnp.asarray([m * margin for m in grid.lengths], grid.dtype)
    span = jnp.asarray(
        [m * (1.0 - 2.0 * margin) for m in grid.lengths], grid.dtype
    )
    return lo + unit * span
