"""Sharp-interface immersed boundary: direct forcing with SDF interpolation.

The staircase obstacle treatment (bcs.face_masks_from_solid) represents a
curved body as blocked faces -- first-order accurate, and the known source
of the high drag bias on coarse cylinder/sphere grids (docs/PARITY.md).
This module upgrades the *velocity* boundary treatment to the classic
direct-forcing immersed-boundary method (capability class: Fadlun et al.
2000, public numerics; the reference mount was empty this session -- see
SURVEY.md SS0 -- so there is no reference counterpart to cite): at the
first fluid faces outside the body, the predictor velocity is replaced by
a linear interpolation along the local surface normal between the no-slip
boundary value and the next fluid sample,

    u_f = (phi_f / phi_nbr) * u_nbr        (stationary body, u_b = 0),

where ``phi`` is the signed distance to the surface (negative inside).
This recovers ~second-order boundary accuracy while keeping the pressure
treatment unchanged (the masked Poisson operator / correction masks from
the staircase cell mask stay exactly as they are -- blocked faces stay
zero, so the projection's compatibility condition is untouched).

Design: everything data-dependent happens at BUILD time in
numpy (normal directions, neighbor choice, interpolation weights); the
per-step apply is a handful of dense masked multiply-adds and axis rolls
-- no gathers, no dynamic shapes, fully fusable by XLA and trivially
shardable under GSPMD (the rolls become halo exchanges).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .bcs import BCTable, periodic_axes
from .grid import GridSpec

Array = jax.Array


@dataclasses.dataclass(eq=False)
class IBMForcing:
    """Per-component dense direct-forcing operator.

    For velocity component ``a`` and direction index ``d`` (enumerating
    the 2*ndim axis neighbors), ``masks[a][d]`` is a one-hot float mask of
    forcing faces whose interpolation neighbor lies one face over along
    ``dirs[d]``; the masks are mutually disjoint. ``w[a]`` holds the
    interpolation weight phi_f/phi_nbr (clamped to [0, 1]; exactly 0 on
    faces whose center is inside the body). ``band[a]`` is the union of
    the masks. Faces outside the band pass through unchanged.
    """

    ndim: int
    dirs: tuple[tuple[int, int], ...]          # (axis, sign) per direction
    masks: tuple[tuple[Array, ...], ...]       # [comp][dir] one-hot floats
    w: tuple[Array, ...]                       # [comp] weights
    band: tuple[Array, ...]                    # [comp] union mask (floats)
    # Moving boundaries (None for stationary bodies): the surface velocity
    # evaluated at each band face's surface foot point, and the "wet solid"
    # mask/velocity -- blocked faces with an open neighbor, which must
    # carry the body velocity so the fluid-side stencils see the motion.
    ub: Optional[tuple[Array, ...]] = None     # [comp] surface velocity
    wet: Optional[tuple[Array, ...]] = None    # [comp] wet-solid masks
    ub_wet: Optional[tuple[Array, ...]] = None
    # Per-comp static bounding boxes ((lo...), (size...)) of the band+wet
    # support, 1-cell margin: the apply is a handful of dense FMAs whose support is a THIN SHELL
    # around the body -- restricting it to the box turns ~20 full-volume
    # HBM passes into box-sized ones (a D=64 body in a 512x256x256 domain
    # is ~100x less traffic). None = full-volume apply (box nearly covers
    # the domain, or a sharded per-block layout where global offsets
    # don't translate).
    box: Optional[tuple] = None

    def apply(self, u: Sequence[Array]) -> tuple[Array, ...]:
        if self.box is not None:
            return self._apply_boxed(u)
        return self._apply_full(u)

    def _apply_boxed(self, u: Sequence[Array]) -> tuple[Array, ...]:
        """The same direct forcing evaluated on the static band bounding
        box only: crop the component, run the roll/mask math on the crop
        (crop-edge wraps multiply mask zeros -- the margin guarantees the
        band sits >= 1 face inside), write the crop back. The operand
        slices are loop-invariant; XLA hoists them out of the scan."""
        sl = jax.lax.dynamic_slice
        out = []
        for a, comp in enumerate(u):
            lo, size = self.box[a]
            crop = sl(comp, lo, size)
            acc = None
            for (axis, sign), m in zip(self.dirs, self.masks[a]):
                term = sl(m, lo, size) * jnp.roll(crop, -sign, axis=axis)
                acc = term if acc is None else acc + term
            wb = sl(self.w[a], lo, size)
            forced = wb * acc
            if self.ub is not None:
                forced = forced + (1.0 - wb) * sl(self.ub[a], lo, size)
            res = jnp.where(sl(self.band[a], lo, size) > 0, forced, crop)
            if self.wet is not None:
                res = jnp.where(
                    sl(self.wet[a], lo, size) > 0,
                    sl(self.ub_wet[a], lo, size), res,
                )
            out.append(jax.lax.dynamic_update_slice(comp, res, lo))
        return tuple(out)

    def _apply_full(self, u: Sequence[Array]) -> tuple[Array, ...]:
        """Impose the interpolated boundary values on the forcing band.

        One explicit pass over pre-forcing values (the standard direct
        forcing; band faces never interpolate from each other because the
        neighbor is required to be strictly farther from the surface AND
        outside the band at build time). With a moving boundary the band
        value is ``(1-w) u_b + w u_nbr`` and the wet solid faces carry the
        body velocity itself (so fluid-side stencils see the motion).
        """
        out = []
        for a, comp in enumerate(u):
            acc = None
            for (axis, sign), m in zip(self.dirs, self.masks[a]):
                # neighbor value at face + sign*e_axis; rolls never wrap
                # into the band (build rejects domain-boundary neighbors)
                term = m * jnp.roll(comp, -sign, axis=axis)
                acc = term if acc is None else acc + term
            forced = self.w[a] * acc
            if self.ub is not None:
                forced = forced + (1.0 - self.w[a]) * self.ub[a]
            res = jnp.where(self.band[a] > 0, forced, comp)
            if self.wet is not None:
                res = jnp.where(self.wet[a] > 0, self.ub_wet[a], res)
            out.append(res)
        return tuple(out)

    def apply_wet(self, u: Sequence[Array]) -> tuple[Array, ...]:
        """Re-impose only the wet-solid body velocities (moving boundaries).

        Used after BC passes that zero the masked faces (they would
        otherwise erase the body motion from the post-projection state and
        corrupt the divergence diagnostic at interface cells)."""
        if self.wet is None:
            return tuple(u)
        if self.box is not None:
            sl = jax.lax.dynamic_slice
            out = []
            for a, comp in enumerate(u):
                lo, size = self.box[a]
                crop = sl(comp, lo, size)
                res = jnp.where(
                    sl(self.wet[a], lo, size) > 0,
                    sl(self.ub_wet[a], lo, size), crop,
                )
                out.append(jax.lax.dynamic_update_slice(comp, res, lo))
            return tuple(out)
        return tuple(
            jnp.where(w > 0, ubw, comp)
            for comp, w, ubw in zip(u, self.wet, self.ub_wet)
        )


def _face_points(grid: GridSpec, a: int) -> tuple[np.ndarray, ...]:
    """Broadcastable numpy coordinate arrays of component ``a``'s faces."""
    nd = grid.ndim
    coords = []
    for k in range(nd):
        h = grid.spacing[k]
        n = grid.shape[k]
        if k == a:
            c = np.arange(n + 1, dtype=np.float64) * h
        else:
            c = (np.arange(n, dtype=np.float64) + 0.5) * h
        shape = [1] * nd
        shape[k] = -1
        coords.append(c.reshape(shape))
    return tuple(coords)


def cell_center_points(grid: GridSpec) -> tuple[np.ndarray, ...]:
    """Broadcastable numpy coordinate arrays of the cell centers."""
    nd = grid.ndim
    coords = []
    for k in range(nd):
        h = grid.spacing[k]
        c = (np.arange(grid.shape[k], dtype=np.float64) + 0.5) * h
        shape = [1] * nd
        shape[k] = -1
        coords.append(c.reshape(shape))
    return tuple(coords)


def solid_from_sdf(grid: GridSpec, sdf: Callable) -> np.ndarray:
    """Cell-centered solid mask (phi < 0) for the Poisson/staircase layer."""
    phi = np.asarray(sdf(*cell_center_points(grid)), np.float64)
    phi = np.broadcast_to(phi, grid.shape)
    return phi < 0.0


def build_ibm(
    grid: GridSpec,
    bcs: BCTable,
    sdf: Callable,
    face_masks: Sequence[Array],
    velocity: Optional[Callable] = None,
) -> Optional[IBMForcing]:
    """Construct the direct-forcing operator from a signed distance field.

    ``sdf(*coords)`` receives broadcastable per-axis coordinate arrays and
    returns the signed distance (negative inside the body). ``face_masks``
    is the staircase per-component open-face mask the Simulation already
    carries -- the forcing band is the set of OPEN faces with at least one
    BLOCKED axis neighbor (the first fluid ring), and the interpolation
    neighbor is chosen along the dominant component of the surface normal
    grad(phi), falling back through the remaining directions ranked by
    |n_k| until one is open, farther from the surface, and outside the
    band. Returns None when the band is empty (no obstacle).

    ``velocity`` (moving boundaries): ``velocity(*coords) -> tuple of nd
    components`` -- the body surface velocity field (e.g. a rigid
    rotation). Evaluated at each forcing face's surface FOOT point
    ``x - phi * grad(phi)/|grad(phi)|``; the interpolation becomes
    ``(1-w) u_b + w u_nbr``, and the wet solid faces (blocked, adjacent to
    an open face) carry the body velocity so fluid-side stencils see it."""
    nd = grid.ndim
    h = grid.spacing
    dirs = tuple((k, s) for k in range(nd) for s in (-1, 1))

    masks_all, w_all, band_all = [], [], []
    ub_all, wet_all, ubwet_all = [], [], []
    any_band = False
    for a in range(nd):
        open_f = np.asarray(face_masks[a], np.float64) > 0.5
        blocked = ~open_f
        phi = np.asarray(sdf(*_face_points(grid, a)), np.float64)
        phi = np.broadcast_to(phi, open_f.shape).copy()

        # first fluid ring: open faces with a blocked axis neighbor
        band = np.zeros_like(open_f)
        for k in range(nd):
            for s in (-1, 1):
                nb = np.roll(blocked, -s, axis=k)
                # a roll that wraps reads the far wall; kill wrapped lanes
                edge = [slice(None)] * nd
                edge[k] = -1 if s == 1 else 0
                nb[tuple(edge)] = False
                band |= nb
        band &= open_f
        if not band.any():
            masks_all.append(tuple(
                jnp.zeros(open_f.shape, grid.dtype) for _ in dirs
            ))
            w_all.append(jnp.zeros(open_f.shape, grid.dtype))
            band_all.append(jnp.zeros(open_f.shape, grid.dtype))
            if velocity is not None:
                z = jnp.zeros(open_f.shape, grid.dtype)
                ub_all.append(z)
                wet_all.append(z)
                ubwet_all.append(z)
            continue
        any_band = True

        # surface normal from phi differences on the face lattice
        grad = np.stack(
            [np.gradient(phi, h[k], axis=k) for k in range(nd)], axis=0
        )
        order = np.argsort(-np.abs(grad), axis=0)  # axes ranked by |n_k|

        masks = [np.zeros(open_f.shape, np.float64) for _ in dirs]
        w = np.zeros(open_f.shape, np.float64)
        assigned = np.zeros_like(band)
        eps = 1e-12
        for rank in range(nd):
            axis_pick = order[rank]
            for k in range(nd):
                for s in (-1, 1):
                    d = dirs.index((k, s))
                    nb_phi = np.roll(phi, -s, axis=k)
                    nb_open = np.roll(open_f & ~band, -s, axis=k)
                    edge = [slice(None)] * nd
                    edge[k] = -1 if s == 1 else 0
                    nb_open[tuple(edge)] = False
                    want = (
                        band & ~assigned
                        & (axis_pick == k)
                        & ((grad[k] > 0) == (s > 0))
                        & nb_open
                        & (nb_phi > phi + eps)
                        & (nb_phi > eps)
                    )
                    if not want.any():
                        continue
                    masks[d][want] = 1.0
                    w[want] = np.clip(phi[want] / nb_phi[want], 0.0, 1.0)
                    assigned |= want
        # faces the fallback never resolved stay unforced (plain open)
        band &= assigned

        masks_all.append(tuple(
            jnp.asarray(m, grid.dtype) for m in masks
        ))
        w_all.append(jnp.asarray(w, grid.dtype))
        band_all.append(jnp.asarray(band.astype(np.float64), grid.dtype))

        if velocity is not None:
            # surface foot points x - phi * n_hat; the body velocity there
            gmag = np.sqrt((grad ** 2).sum(axis=0))
            gmag = np.where(gmag > eps, gmag, 1.0)
            pts = np.broadcast_arrays(*_face_points(grid, a))
            feet = tuple(
                pts[k] - phi * grad[k] / gmag for k in range(nd)
            )
            vb = np.broadcast_to(
                np.asarray(velocity(*feet)[a], np.float64), open_f.shape
            )
            ub_all.append(jnp.asarray(np.where(band, vb, 0.0), grid.dtype))
            # wet solid faces: blocked with an open axis neighbor
            wet = np.zeros_like(open_f)
            for k in range(nd):
                for s in (-1, 1):
                    nb = np.roll(open_f, -s, axis=k)
                    edge = [slice(None)] * nd
                    edge[k] = -1 if s == 1 else 0
                    nb[tuple(edge)] = False
                    wet |= nb
            wet &= blocked
            wet_all.append(jnp.asarray(wet.astype(np.float64), grid.dtype))
            ubwet_all.append(jnp.asarray(
                np.where(wet, vb, 0.0), grid.dtype
            ))

    if not any_band:
        return None
    # Static per-comp band bounding boxes (1-face margin for the apply's
    # unit rolls). Skipped when the shell covers most of the domain.
    boxes = []
    frac_max = 0.0
    for a in range(nd):
        supp = np.asarray(band_all[a]) > 0
        if velocity is not None:
            supp = supp | (np.asarray(wet_all[a]) > 0)
        shape = supp.shape
        if not supp.any():
            boxes.append(((0,) * nd, (1,) * nd))
            continue
        nzs = np.nonzero(supp)
        lo, hi = [], []
        for ax in range(nd):
            l = max(int(nzs[ax].min()) - 1, 0)
            hh = min(int(nzs[ax].max()) + 2, shape[ax])
            lo.append(l)
            hi.append(hh)
        size = tuple(h_ - l_ for l_, h_ in zip(lo, hi))
        frac_max = max(frac_max,
                       float(np.prod(size)) / float(np.prod(shape)))
        boxes.append((tuple(lo), size))
    box = tuple(boxes) if frac_max < 0.5 else None
    return IBMForcing(
        ndim=nd,
        dirs=dirs,
        masks=tuple(masks_all),
        w=tuple(w_all),
        band=tuple(band_all),
        ub=tuple(ub_all) if velocity is not None else None,
        wet=tuple(wet_all) if velocity is not None else None,
        ub_wet=tuple(ubwet_all) if velocity is not None else None,
        box=box,
    )
