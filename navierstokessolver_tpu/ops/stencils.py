"""Finite-difference stencils on the staggered grid (pure-jnp reference path).

Capability parity: the reference's "explicit advection-diffusion stencil
update" and the divergence/gradient pieces of the projection step
(SURVEY.md SS2 rows: advection, diffusion, divergence, velocity correction).
The reference's advection discretization is unknown (SURVEY.md SS0.3 TODO);
this module pins a documented choice: *advective-form central differences
blended with first-order donor-cell upwinding* via ``upwind_gamma`` in [0, 1]
(gamma = 0 -> pure central, the classic staggered-grid default; gamma > 0 for
high-Re robustness).

These jnp implementations are the step the solver runs on every backend,
and the reference semantics any future hand-written kernel is validated
against.

All functions are shape-polymorphic over 2D/3D: velocity is a tuple of
face-normal components, component ``a`` staggered along axis ``a``.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..bcs import BCTable, pad_transverse, periodic_axes
from ..grid import GridSpec

Array = jax.Array


def _sl(ndim: int, axis: int, s: slice) -> tuple:
    idx = [slice(None)] * ndim
    idx[axis] = s
    return tuple(idx)


def _wrap_extend_faces(arr: Array, axis: int) -> Array:
    """Periodic own-axis extension of a face array [f0..fn] (fn == f0):
    drop the duplicate last face and add one wrap ghost on each side, so a
    centered slice(1, -1) covers ALL n distinct faces with wrap neighbors."""
    nd = arr.ndim
    work = arr[_sl(nd, axis, slice(0, -1))]
    lo = work[_sl(nd, axis, slice(-1, None))]
    hi = work[_sl(nd, axis, slice(0, 1))]
    return jnp.concatenate([lo, work, hi], axis=axis)


def _add_interior(arr: Array, axis: int, delta: Array) -> Array:
    """``arr[1:-1 along axis] += delta`` via slice+concat.

    Scatter (``.at[].add``) is avoided on purpose: it is mis-partitioned
    under sharding constraints (see bcs._set_face note).
    """
    nd = arr.ndim
    first = _sl(nd, axis, slice(0, 1))
    mid = _sl(nd, axis, slice(1, -1))
    last = _sl(nd, axis, slice(-1, None))
    return jnp.concatenate(
        [arr[first], arr[mid] + delta, arr[last]], axis=axis
    )


def divergence(grid: GridSpec, u: Sequence[Array]) -> Array:
    """Cell-centered divergence of a staggered velocity field."""
    h = grid.spacing
    nd = grid.ndim
    out = None
    for a, comp in enumerate(u):
        d = (
            comp[_sl(nd, a, slice(1, None))] - comp[_sl(nd, a, slice(0, -1))]
        ) / h[a]
        out = d if out is None else out + d
    return out


def divergence_ap(grid: GridSpec, u: Sequence[Array], ap) -> Array:
    """Cut-cell (apertured) divergence: ``sum_a (a_hi u_hi - a_lo u_lo)/h_a``
    with ``ap`` the per-axis full face-aperture arrays (cutcell.py). The
    matching Poisson operator is ops/poisson.build_poisson_op_cut; using
    the pair keeps the projection exact on cut cells."""
    h = grid.spacing
    nd = grid.ndim
    out = None
    for a, comp in enumerate(u):
        au = ap[a] * comp
        d = (
            au[_sl(nd, a, slice(1, None))] - au[_sl(nd, a, slice(0, -1))]
        ) / h[a]
        out = d if out is None else out + d
    return out


def pressure_gradient(grid: GridSpec, p: Array, axis: int) -> Array:
    """dp/dx_axis at the *interior* faces along ``axis`` (shape - e_axis)."""
    nd = grid.ndim
    return (
        p[_sl(nd, axis, slice(1, None))] - p[_sl(nd, axis, slice(0, -1))]
    ) / grid.spacing[axis]


def correct_velocity(
    grid: GridSpec,
    u: Sequence[Array],
    p: Array,
    scale,
    corr_masks=None,
    periodic: Sequence[bool] | None = None,
) -> tuple[Array, ...]:
    """Projection corrector: ``u -= scale * grad(p)`` on interior faces.

    ``scale`` is ``dt / rho``. Boundary-face DOFs are left untouched (they are
    re-imposed by apply_velocity_bcs); obstacle-adjacent faces are masked.
    Along periodic axes every face is corrected with the wrap gradient
    (face 0 sees ``p[0] - p[n-1]``) and the duplicate face n mirrors face 0.
    """
    nd = grid.ndim
    out = []
    for a, comp in enumerate(u):
        if periodic is not None and periodic[a]:
            g = (p - jnp.roll(p, 1, axis=a)) / grid.spacing[a]
            if corr_masks is not None:
                g = g * corr_masks[a]
            work = comp[_sl(nd, a, slice(0, -1))] - scale * g
            out.append(
                jnp.concatenate(
                    [work, work[_sl(nd, a, slice(0, 1))]], axis=a
                )
            )
            continue
        g = pressure_gradient(grid, p, a)
        if corr_masks is not None:
            g = g * corr_masks[a]
        out.append(_add_interior(comp, a, -scale * g))
    return tuple(out)


def laplacian_component(
    grid: GridSpec, bcs: BCTable, comp: int, arr: Array
) -> Array:
    """Viscous Laplacian of velocity component ``comp`` at its interior faces.

    Along the staggering axis the boundary DOFs are in-array; along transverse
    axes ghost cells come from :func:`pad_transverse`. Result shape: interior
    faces along ``comp`` (n_comp - 1), full extent elsewhere.
    """
    nd = grid.ndim
    h = grid.spacing
    if periodic_axes(grid, bcs)[comp]:
        # wrap-extend along the staggering axis: the "interior" slice then
        # covers all n distinct faces with periodic neighbors.
        arr = _wrap_extend_faces(arr, comp)
    padded = pad_transverse(grid, bcs, comp, arr)
    # Center slice of the padded array matching interior faces of `comp`.
    center_idx = []
    for ax in range(nd):
        if ax == comp:
            center_idx.append(slice(1, -1))
        else:
            center_idx.append(slice(1, -1))
    # Note: padded is padded on transverse axes only (plus the wrap extension
    # above for a periodic staggering axis); along `comp` slice(1,-1) selects
    # interior faces of the raw array (all faces in the periodic case).
    center = padded[tuple(center_idx)]
    out = jnp.zeros_like(center)
    for ax in range(nd):
        idx_m = list(center_idx)
        idx_p = list(center_idx)
        if ax == comp:
            idx_m[ax] = slice(0, -2)
            idx_p[ax] = slice(2, None)
        else:
            idx_m[ax] = slice(0, -2)
            idx_p[ax] = slice(2, None)
        out = out + (
            padded[tuple(idx_p)] - 2.0 * center + padded[tuple(idx_m)]
        ) / (h[ax] * h[ax])
    return out


def _transverse_velocity_at(
    grid: GridSpec, u: Sequence[Array], comp: int, trans: int,
    wrap_comp: bool = False,
) -> Array:
    """Average component ``trans`` onto the interior-face locations of
    component ``comp`` (4-point average in 2D, per-axis pair averages in ND).

    ``wrap_comp``: comp's axis is periodic -- produce values at ALL n faces
    by wrapping the cell pair of face 0 around."""
    nd = grid.ndim
    ut = u[trans]
    if wrap_comp:
        ut = jnp.concatenate(
            [ut[_sl(nd, comp, slice(-1, None))], ut], axis=comp
        )
    # Average adjacent cells along `comp`'s axis: cell pairs -> interior faces.
    m = 0.5 * (
        ut[_sl(nd, comp, slice(0, -1))] + ut[_sl(nd, comp, slice(1, None))]
    )
    # Average adjacent faces along `trans`'s axis: faces -> cell centers.
    m = 0.5 * (m[_sl(nd, trans, slice(0, -1))] + m[_sl(nd, trans, slice(1, None))])
    return m


def advection_component(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[Array],
    comp: int,
    upwind_gamma: float = 0.0,
) -> Array:
    """Advective-form (u . grad) u_comp at interior faces of ``comp``.

    Central differences blended with donor-cell upwinding:
      ``d = gamma * upwind + (1 - gamma) * central``.
    """
    nd = grid.ndim
    h = grid.spacing
    arr = u[comp]
    wrap_own = periodic_axes(grid, bcs)[comp]
    if wrap_own:
        arr = _wrap_extend_faces(arr, comp)
    padded = pad_transverse(grid, bcs, comp, arr)
    center_idx = tuple(slice(1, -1) for _ in range(nd))
    center = padded[tuple(center_idx)]

    out = jnp.zeros_like(center)
    for ax in range(nd):
        idx_m = list(center_idx)
        idx_p = list(center_idx)
        idx_m[ax] = slice(0, -2)
        idx_p[ax] = slice(2, None)
        um = padded[tuple(idx_m)]
        up = padded[tuple(idx_p)]
        central = (up - um) / (2.0 * h[ax])
        if ax == comp:
            vel = center
        else:
            vel = _transverse_velocity_at(grid, u, comp, ax, wrap_own)
        if upwind_gamma > 0.0:
            fwd = (up - center) / h[ax]
            bwd = (center - um) / h[ax]
            upw = jnp.where(vel > 0.0, bwd, fwd)
            d = upwind_gamma * upw + (1.0 - upwind_gamma) * central
        else:
            d = central
        out = out + vel * d
    return out


def predictor(
    grid: GridSpec,
    bcs: BCTable,
    u: Sequence[Array],
    dt,
    nu: float,
    upwind_gamma: float = 0.0,
    forcing: Sequence[Array] | None = None,
) -> tuple[Array, ...]:
    """Explicit advection-diffusion predictor: ``u* = u + dt*(-adv + nu*lap [+ f])``.

    Updates interior faces only; boundary DOFs are re-imposed by the BC pass.
    """
    nd = grid.ndim
    per = periodic_axes(grid, bcs)
    out = []
    for a, comp in enumerate(u):
        adv = advection_component(grid, bcs, u, a, upwind_gamma)
        lap = laplacian_component(grid, bcs, a, comp)
        rhs = -adv + nu * lap
        if forcing is not None and forcing[a] is not None:
            rhs = rhs + forcing[a]
        if per[a]:
            # rhs covers ALL n distinct faces; rebuild with the duplicate
            # face n mirroring face 0.
            work = comp[_sl(nd, a, slice(0, -1))] + dt * rhs
            out.append(
                jnp.concatenate(
                    [work, work[_sl(nd, a, slice(0, 1))]], axis=a
                )
            )
        else:
            out.append(_add_interior(comp, a, dt * rhs))
    return tuple(out)


def vorticity_2d(grid: GridSpec, u: Sequence[Array]) -> Array:
    """z-vorticity dv/dx - du/dy at interior grid nodes ((nx-1, ny-1))."""
    if grid.ndim != 2:
        raise ValueError("vorticity_2d is 2D only")
    dx, dy = grid.spacing
    uu, vv = u
    dvdx = (vv[1:, 1:-1] - vv[:-1, 1:-1]) / dx
    dudy = (uu[1:-1, 1:] - uu[1:-1, :-1]) / dy
    return dvdx - dudy


def streamfunction_2d(grid: GridSpec, u: Sequence[Array]) -> Array:
    """Discrete streamfunction psi at grid nodes, shape (nx+1, ny+1).

    SURVEY.md SS3.3 lists streamfunction as an (optional) reference-derived
    output. MAC-exact construction: psi(i, j+1) - psi(i, j) = u[i, j] * dy,
    psi(i, 0) = 0 along the bottom boundary nodes -- then
    psi(i+1, j) - psi(i, j) = -v[i, j] * dx holds identically wherever the
    discrete divergence vanishes (i.e. everywhere after projection), making
    the column integral path-independent to solver tolerance. Contours of
    psi are streamlines; the cavity's primary-vortex psi_min is a classic
    Ghia et al. (1982) benchmark quantity."""
    if grid.ndim != 2:
        raise ValueError("streamfunction_2d is 2D only")
    dy = grid.spacing[1]
    uu = u[0]  # (nx+1, ny) x-face normal velocities
    psi = jnp.cumsum(uu, axis=1) * dy
    return jnp.pad(psi, [(0, 0), (1, 0)])


def vorticity_magnitude_3d(grid: GridSpec, u: Sequence[Array]) -> Array:
    """|curl u| at interior grid nodes (visualization/diagnostics; shape
    (nx-1, ny-1, nz-1) -- each curl component is averaged from its natural
    edge location to the shared corner nodes)."""
    if grid.ndim != 3:
        raise ValueError("vorticity_magnitude_3d is 3D only")
    h = grid.spacing
    uu, vv, ww = u

    def d(arr, axis, ax_h):
        nd = arr.ndim
        hi = _sl(nd, axis, slice(1, None))
        lo = _sl(nd, axis, slice(0, -1))
        return (arr[hi] - arr[lo]) / h[ax_h]

    def avg(arr, axis):
        nd = arr.ndim
        hi = _sl(nd, axis, slice(1, None))
        lo = _sl(nd, axis, slice(0, -1))
        return 0.5 * (arr[hi] + arr[lo])

    # omega_x = dw/dy - dv/dz at (cell, node, node) -> avg over x pairs
    wx = d(ww[:, :, 1:-1], 1, 1) - d(vv[:, 1:-1, :], 2, 2)
    # omega_y = du/dz - dw/dx at (node, cell, node) -> avg over y pairs
    wy = d(uu[1:-1, :, :], 2, 2) - d(ww[:, :, 1:-1], 0, 0)
    # omega_z = dv/dx - du/dy at (node, node, cell) -> avg over z pairs
    wz = d(vv[:, 1:-1, :], 0, 0) - d(uu[1:-1, :, :], 1, 1)
    wx = avg(wx, 0)
    wy = avg(wy, 1)
    wz = avg(wz, 2)
    return jnp.sqrt(wx * wx + wy * wy + wz * wz)


def q_criterion_3d(grid: GridSpec, u: Sequence[Array]) -> Array:
    """Q-criterion at cell centers: Q = -(1/2) tr(G G) with G_ij = du_i/dx_j
    (equivalently (||Omega||^2 - ||S||^2)/2 -- positive where rotation beats
    strain; the standard 3D vortex-identification isosurface field for
    wake visualization). Gradients are central differences of the
    center-interpolated velocity (one-sided at domain edges)."""
    if grid.ndim != 3:
        raise ValueError("q_criterion_3d is 3D only")
    from ..grid import interpolate_to_centers

    uc = interpolate_to_centers(grid, u)
    g = [
        [jnp.gradient(uc[i], grid.spacing[j], axis=j) for j in range(3)]
        for i in range(3)
    ]
    q = jnp.zeros_like(uc[0])
    for i in range(3):
        for j in range(3):
            q = q - 0.5 * g[i][j] * g[j][i]
    return q


def max_cfl(grid: GridSpec, u: Sequence[Array], dt) -> Array:
    """max over axes of |u| dt / h (advective CFL number)."""
    cfl = jnp.asarray(0.0, grid.dtype)
    for a, comp in enumerate(u):
        cfl = jnp.maximum(cfl, jnp.max(jnp.abs(comp)) * dt / grid.spacing[a])
    return cfl
