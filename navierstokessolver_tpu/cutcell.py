"""Cut-cell (apertured) sharp-interface pressure treatment.

The staircase Poisson masking represents a curved body as fully-blocked
faces between cell-center-classified solid/fluid cells -- first-order in h
and the leading error term at curved boundaries once the VELOCITY side is
sharp (ibm.py direct forcing; docs/PARITY.md Cd convergence table). This
module upgrades the PRESSURE side to a cut-cell finite volume: each cell
face carries an aperture alpha in [0, 1] (its fluid-open fraction, from
the signed distance field), and

  * the Poisson operator becomes  (A p)_i = sum_f alpha_f (p_nb - p_i)/h^2
    (ops/poisson.PoissonOp.ap; still matrix-free, still symmetric --
    alpha is shared by the two cells it separates);
  * the divergence / Poisson RHS becomes the apertured flux sum
    sum_a (alpha_hi u_hi - alpha_lo u_lo)/h_a  (:func:`divergence_ap`);
  * the velocity correction applies the plain face gradient on every face
    with alpha > 0 (the existing corr_masks mechanism).

Together these keep the projection EXACT: div_ap(u_new) = div_ap(u*) -
(dt/rho) A p = 0 to solver tolerance, by construction. Solid cells
(volume fraction 0 or no open face) keep identity rows.

Capability class: standard cut-cell/embedded-boundary Poisson (public
numerics); the reference mount was empty this session (SURVEY.md SS0) so
there is no reference counterpart to cite -- this extends the SURVEY SS2
"obstacle mask" row's accuracy beyond the reference class.

Design: apertures are computed ONCE at build time in numpy (clipped
linear reconstruction of the SDF on a subcell lattice -- EXACT for planar
cuts, O(1/k^2) worst-case on smooth curved boundaries, no geometry code
on device);
the per-iteration cost over the staircase operator is two extra f32
coefficient reads per axis, and everything stays branch-free inside the
same lax.while_loop solvers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .grid import GridSpec

# faces with aperture below this are treated as closed (kills the
# small-cell stiffness of nearly-grazing cuts; the velocity there is
# zeroed by the face mask, so no flux is lost from the discrete system)
ALPHA_MIN = 0.01


def _seg_frac(v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    """Length fraction of {phi > 0} on a segment with endpoint SDF values
    ``v0``/``v1``, from the linear reconstruction: ((v1)+ - (v0)+)/(v1-v0)
    (sign-symmetric; exact for any affine phi). Degenerate v0 == v1 falls
    back to the indicator."""
    b = v1 - v0
    pos0 = np.maximum(v0, 0.0)
    pos1 = np.maximum(v1, 0.0)
    safe = np.abs(b) > 1e-300
    f = np.where(safe, (pos1 - pos0) / np.where(safe, b, 1.0),
                 (v0 > 0.0).astype(np.float64))
    return np.clip(f, 0.0, 1.0)


def _rect_frac(v00, v10, v01, v11) -> np.ndarray:
    """Area fraction of {phi > 0} on a rectangle with corner SDF values
    ``vXY`` (X along the first transverse axis, Y along the second), from
    the AFFINE least-squares reconstruction of the four corners:

        area = ((w11)+^2 + (w00)+^2 - (w10)+^2 - (w01)+^2) / (2 b c)

    (w = affine-fit corner values, b/c the fit's edge slopes; the identity
    is the closed form of integrating the 1D clipped-segment rule, and is
    invariant under either axis flip so any nonzero b, c works). Exact for
    planar interfaces -- affine data has zero twist, so w == v and the
    formula integrates the half-plane clip exactly. Near-degenerate slopes
    (cut parallel to an axis) fall back to the 1D segment rule, which is
    exact there."""
    b = 0.5 * ((v10 - v00) + (v11 - v01))   # mean slope, first axis
    c = 0.5 * ((v01 - v00) + (v11 - v10))   # mean slope, second axis
    m = 0.25 * (v00 + v10 + v01 + v11)
    w00 = m - 0.5 * (b + c)
    w10 = m + 0.5 * (b - c)
    w01 = m - 0.5 * (b - c)
    w11 = m + 0.5 * (b + c)
    pos = lambda x: np.maximum(x, 0.0)  # noqa: E731
    num = pos(w11) ** 2 + pos(w00) ** 2 - pos(w10) ** 2 - pos(w01) ** 2
    scale = np.abs(b) + np.abs(c) + np.abs(m) + 1e-300
    bc_ok = (np.abs(b) > 1e-9 * scale) & (np.abs(c) > 1e-9 * scale)
    den = 2.0 * b * c
    area = np.where(bc_ok, num / np.where(bc_ok, den, 1.0), 0.0)
    # b ~ 0: phi constant along the first axis -> 1D cut along the second
    # (and vice versa); both ~ 0: indicator of the (constant) value
    area = np.where(bc_ok, area,
                    np.where(np.abs(b) <= np.abs(c),
                             _seg_frac(w00, w01), _seg_frac(w00, w10)))
    return np.clip(area, 0.0, 1.0)


def face_apertures(
    grid: GridSpec, sdf: Callable, k: int = 4
) -> tuple[np.ndarray, ...]:
    """Per-axis FULL face-aperture arrays (shape = grid.face_shape(a)):
    the fluid fraction (sdf > 0) of each face, from the SDF's LINEAR
    reconstruction on a k-per-axis subcell lattice (corner samples;
    :func:`_seg_frac` on 2D grids' face segments, :func:`_rect_frac` on
    3D grids' face rectangles). EXACT for planar interfaces at any angle
    (every subcell sees affine data); for smooth curved boundaries each
    cut subcell carries the linear-interpolant error O((h/k)^2), so the
    per-face worst case is O(1/k^2) -- strictly better than the O(1/k)
    worst case of the former midpoint-counting estimator (ADVICE r3).

    SPARSE evaluation: one dense SDF pass over the face CENTERS
    classifies faces via the signed-distance bound -- ``sdf`` is a true
    distance near the interface (every ``cases/`` body is; 1-Lipschitz),
    so |phi(center)| exceeding 1.5x the face half-diagonal PROVES the
    face uniformly in/out -- and the subcell reconstruction runs only on
    the O(surface) shell of candidates. At 256x128x128 this turned a
    ~7-minute dense-lattice build into seconds."""
    nd = grid.ndim
    h = grid.spacing
    out = []
    for a in range(nd):
        tr = [d for d in range(nd) if d != a]
        # dense face-center values: classification AND the IBM-consistency
        # closing below share this one evaluation
        centers = []
        for d in range(nd):
            if d == a:
                c = np.arange(grid.shape[d] + 1, dtype=np.float64) * h[d]
            else:
                c = (np.arange(grid.shape[d], dtype=np.float64) + 0.5) * h[d]
            shp = [1] * nd
            shp[d] = -1
            centers.append(c.reshape(shp))
        phi_c = np.broadcast_to(
            np.asarray(sdf(*centers), np.float64), grid.face_shape(a)
        )
        alpha = (phi_c > 0.0).astype(np.float64)
        halfdiag = 0.5 * float(np.sqrt(sum(h[t] ** 2 for t in tr)))
        idx = np.argwhere(np.abs(phi_c) <= 1.5 * halfdiag)
        if idx.size:
            # per-candidate subcell corner lattices, sdf broadcast over
            # (N, k+1[, k+1]) -- dimension order preserved
            args = []
            lat_shape = [len(idx)] + [k + 1] * (nd - 1)
            for d in range(nd):
                if d == a:
                    col = idx[:, d].astype(np.float64) * h[d]
                    col = col.reshape([-1] + [1] * (nd - 1))
                else:
                    off = np.arange(k + 1, dtype=np.float64) * (h[d] / k)
                    shp = [1] * len(lat_shape)
                    shp[1 + tr.index(d)] = -1
                    col = (idx[:, d].astype(np.float64) * h[d]
                           ).reshape([-1] + [1] * (nd - 1)) \
                        + off.reshape(shp)
                args.append(col)
            phi = np.broadcast_to(
                np.asarray(sdf(*args), np.float64), lat_shape
            )
            if nd == 2:
                fr = _seg_frac(phi[:, :-1], phi[:, 1:]).mean(axis=1)
            else:
                fr = _rect_frac(
                    phi[:, :-1, :-1], phi[:, 1:, :-1],
                    phi[:, :-1, 1:], phi[:, 1:, 1:],
                ).mean(axis=(1, 2))
            alpha[tuple(idx.T)] = fr
        # consistency with the IBM velocity treatment: a face whose
        # CENTER is inside the body has its velocity DOF forced toward
        # the body value (ibm.py clamps w = phi_f/phi_nbr to 0 there), so
        # keeping a partial aperture open on it would count a systematic
        # flux deficit into the continuity equation -- close it. The open
        # set then matches where the velocity DOF is meaningful (alpha of
        # surviving cut faces is in ~(0.5, 1]).
        alpha = np.where(phi_c > 0.0, alpha, 0.0)
        alpha[alpha < ALPHA_MIN] = 0.0
        out.append(alpha)
    return tuple(out)


def volume_fractions(
    grid: GridSpec, sdf: Callable, k: int = 4
) -> np.ndarray:
    """Cell fluid-volume fractions by k^nd midpoint subsampling -- SPARSE
    like :func:`face_apertures`: a dense cell-center SDF pass classifies
    cells via the signed-distance bound (|phi(center)| > 1.5x the cell
    half-diagonal proves the cell uniformly in/out), midpoint subsampling
    runs only on the O(surface) candidate shell."""
    nd = grid.ndim
    h = grid.spacing
    centers = []
    for d in range(nd):
        c = (np.arange(grid.shape[d], dtype=np.float64) + 0.5) * h[d]
        shp = [1] * nd
        shp[d] = -1
        centers.append(c.reshape(shp))
    phi_c = np.broadcast_to(
        np.asarray(sdf(*centers), np.float64), grid.shape
    )
    frac = (phi_c > 0.0).astype(np.float64)
    halfdiag = 0.5 * float(np.sqrt(sum(hh ** 2 for hh in h)))
    idx = np.argwhere(np.abs(phi_c) <= 1.5 * halfdiag)
    if idx.size:
        lat_shape = [len(idx)] + [k] * nd
        args = []
        for d in range(nd):
            sub = (np.arange(k, dtype=np.float64) + 0.5) * (h[d] / k)
            shp = [1] * (nd + 1)
            shp[1 + d] = -1
            args.append(
                (idx[:, d].astype(np.float64) * h[d]).reshape(
                    [-1] + [1] * nd
                ) + sub.reshape(shp)
            )
        phi = np.broadcast_to(np.asarray(sdf(*args), np.float64), lat_shape)
        frac[tuple(idx.T)] = (phi > 0.0).reshape(len(idx), -1).mean(axis=1)
    return frac


def cut_geometry(grid: GridSpec, sdf: Callable, k: int = 8):
    """(apertures, fluid, solid): the consistent cut-cell classification.

    A cell is FLUID iff it has positive volume fraction AND at least one
    open face (isolated slivers become solid); apertures of faces touching
    a solid cell are closed so the operator/divergence/masks all agree.
    """
    nd = grid.ndim

    def inner_sl(a):
        s = [slice(None)] * nd
        s[a] = slice(1, -1)
        return tuple(s)

    def lo_sl(a):   # cell's low face / low-side neighbor cell
        s = [slice(None)] * nd
        s[a] = slice(0, -1)
        return tuple(s)

    def hi_sl(a):
        s = [slice(None)] * nd
        s[a] = slice(1, None)
        return tuple(s)

    ap = [a.copy() for a in face_apertures(grid, sdf, k)]
    vol = volume_fractions(grid, sdf, max(4, k // 2))
    fluid = vol > 0.0
    # fixed point: close faces touching a solid cell; a fluid cell with no
    # remaining open face becomes solid (isolated sliver) -> repeat
    while True:
        for a in range(nd):
            both = fluid[lo_sl(a)] & fluid[hi_sl(a)]
            ap[a][inner_sl(a)] *= both.astype(np.float64)
            first = [slice(None)] * nd
            first[a] = 0
            last = [slice(None)] * nd
            last[a] = -1
            cf = [slice(None)] * nd
            cf[a] = 0
            cl = [slice(None)] * nd
            cl[a] = -1
            ap[a][tuple(first)] *= fluid[tuple(cf)].astype(np.float64)
            ap[a][tuple(last)] *= fluid[tuple(cl)].astype(np.float64)
        open_any = np.zeros(grid.shape, bool)
        for a in range(nd):
            open_any |= (ap[a][lo_sl(a)] > 0) | (ap[a][hi_sl(a)] > 0)
        new_fluid = fluid & open_any
        if (new_fluid == fluid).all():
            break
        fluid = new_fluid
    return tuple(ap), fluid, ~fluid
