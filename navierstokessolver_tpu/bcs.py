"""Boundary conditions for the staggered grid.

Capability parity: the reference's BC handling -- no-slip walls, moving lid,
inflow/outflow, interior obstacle masks (SURVEY.md SS2 BC rows; BASELINE.json
configs). The reference mount was empty (SURVEY.md SS0), so the exact ghost
treatment is a pinned choice, documented here:

  * WALL / INFLOW are velocity-Dirichlet faces. The *normal* velocity DOF
    lives on the boundary face and is set directly. The *tangential*
    components are enforced with linear-reflection ghost cells
    ``ghost = 2*u_wall - u_interior`` (second-order at the wall).
  * OUTFLOW is zero-gradient for all velocity components (``ghost = edge``;
    boundary-normal DOF copied from its interior neighbor) and a homogeneous
    Dirichlet pressure face in the Poisson operator (see ops/poisson.py).
  * Interior obstacles are static solid-cell masks; every face touching a
    solid cell carries zero velocity (first-order immersed boundary), and the
    Poisson stencil sees a homogeneous Neumann condition at fluid/solid faces.

All BC application is pure-functional (returns new arrays) so it composes
with jit/scan/sharding. Pressure BCs are *folded into the Poisson operator
coefficients* rather than applied per-sweep -- this keeps the inner
relaxation loop a single fused stencil with no branching.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .grid import GridSpec

Array = jax.Array
Value = Union[float, Array]


class BCKind(enum.Enum):
    WALL = "wall"        # no-slip / moving wall: velocity Dirichlet
    OUTFLOW = "outflow"  # zero-gradient velocity, p = 0 (Dirichlet) for pressure
    INFLOW = "inflow"    # prescribed velocity (profile allowed): Dirichlet
    SLIP = "slip"        # free-slip/symmetry: normal u = 0, tangential d/dn = 0
    PERIODIC = "periodic"  # wrap-around; must be set on BOTH faces of an axis
    # Convective (non-reflective) outlet: the boundary-normal DOF obeys
    # du/dt + U du/dn = 0, discretized once per step on u* right after the
    # predictor (apply_convective_outlets), held fixed through the
    # projection, then pressure-corrected with the Dirichlet-ghost gradient
    # (correct_convective_faces). Pressure sees the same p=0 Dirichlet face
    # as OUTFLOW.
    CONVECTIVE = "convective"


# Faces where the *normal* velocity DOF is Dirichlet.
_DIRICHLET_KINDS = (BCKind.WALL, BCKind.INFLOW, BCKind.SLIP)
# Faces treated as zero-gradient outlets by the mid-step BC passes.
_OUTLET_KINDS = (BCKind.OUTFLOW, BCKind.CONVECTIVE)
# Faces whose *tangential* ghost is a Dirichlet reflection (SLIP excluded:
# tangential components are zero-gradient there).
_TANGENTIAL_REFLECT_KINDS = (BCKind.WALL, BCKind.INFLOW)


@dataclasses.dataclass(frozen=True)
class BCSpec:
    """Boundary condition on one domain face.

    ``velocity`` is the prescribed wall/inlet velocity vector; each entry may
    be a scalar or an array broadcastable to the face slice (e.g. a parabolic
    inflow profile for the normal component). Ignored for OUTFLOW.
    """

    kind: BCKind
    velocity: tuple[Value, ...] = ()

    @staticmethod
    def wall(velocity: tuple[Value, ...] = ()) -> "BCSpec":
        return BCSpec(BCKind.WALL, velocity)

    @staticmethod
    def inflow(velocity: tuple[Value, ...]) -> "BCSpec":
        return BCSpec(BCKind.INFLOW, velocity)

    @staticmethod
    def outflow() -> "BCSpec":
        return BCSpec(BCKind.OUTFLOW)

    @staticmethod
    def convective(speed: float) -> "BCSpec":
        """Convective outlet with phase speed ``speed`` (e.g. the mean
        inflow velocity); stores it in the velocity slot for the face
        normal (the only component the convective update touches)."""
        return BCSpec(BCKind.CONVECTIVE, (float(speed),))

    @staticmethod
    def slip() -> "BCSpec":
        return BCSpec(BCKind.SLIP)

    @staticmethod
    def periodic() -> "BCSpec":
        return BCSpec(BCKind.PERIODIC)

    def component(self, comp: int, ndim: int) -> Value:
        if not self.velocity:
            return 0.0
        if len(self.velocity) != ndim:
            raise ValueError(
                f"BC velocity {self.velocity} has wrong rank for ndim={ndim}"
            )
        return self.velocity[comp]


# A BCTable maps (axis, side) -> BCSpec, side 0 = low face, 1 = high face.
Face = tuple[int, int]
BCTable = Mapping[Face, BCSpec]


def bcs_time_dependent(bcs: BCTable) -> bool:
    """True when any BC velocity entry is a callable of time."""
    return any(
        callable(v) for spec in bcs.values() for v in spec.velocity
    )


def bcs_values_traced(bcs: BCTable) -> bool:
    """True when any BC velocity entry is a non-concretizable (traced)
    scalar -- the shape a time-dependent run's :func:`resolve_bcs` output
    takes inside ``jit``."""
    import jax

    return any(
        isinstance(v, jax.core.Tracer)
        for spec in bcs.values() for v in spec.velocity
    )


def resolve_bcs(bcs: BCTable, t) -> dict:
    """Evaluate callable BC velocity entries at (traced) time ``t``.

    Pulsatile inlets / oscillating lids: a velocity entry may be a
    function ``v(t) -> scalar or face-broadcastable array``; the step
    resolves it against the carried ``State.t`` each step, so the whole
    time-dependent run still lives inside one jitted ``lax.scan``."""
    out = {}
    for face, spec in bcs.items():
        if any(callable(v) for v in spec.velocity):
            vel = tuple(v(t) if callable(v) else v for v in spec.velocity)
            spec = dataclasses.replace(spec, velocity=vel)
        out[face] = spec
    return out


def validate_bcs(grid: GridSpec, bcs: BCTable) -> None:
    for a in range(grid.ndim):
        for side in (0, 1):
            if (a, side) not in bcs:
                raise ValueError(f"missing BC for face (axis={a}, side={side})")
        lo_p = bcs[(a, 0)].kind is BCKind.PERIODIC
        hi_p = bcs[(a, 1)].kind is BCKind.PERIODIC
        if lo_p != hi_p:
            raise ValueError(
                f"axis {a}: PERIODIC must be set on both faces"
            )
        if lo_p and grid.shape[a] % 2:
            raise ValueError(
                f"axis {a}: periodic extent must be even (red-black "
                f"coloring wraps consistently only for even n)"
            )


def periodic_axes(grid: GridSpec, bcs: BCTable) -> tuple[bool, ...]:
    return tuple(
        bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(grid.ndim)
    )


def no_slip_box(grid: GridSpec) -> dict[Face, BCSpec]:
    """All-walls, zero-velocity BC table (the cavity starting point)."""
    zeros = (0.0,) * grid.ndim
    return {
        (a, s): BCSpec.wall(zeros) for a in range(grid.ndim) for s in (0, 1)
    }


def _face_slice(arr: Array, axis: int, index) -> Array:
    idx = [slice(None)] * arr.ndim
    idx[axis] = index
    return arr[tuple(idx)]


def _set_face(arr: Array, axis: int, side: int, value) -> Array:
    """Replace the boundary slab (side 0 = first, 1 = last) along ``axis``.

    Implemented with slice+concatenate, NOT ``.at[].set``: scatter ops are
    mis-partitioned under sharding constraints on this backend (verified by
    a minimal repro; concat lowers to halo-free slicing and is exact).
    """
    nd = arr.ndim
    value = jnp.asarray(value, arr.dtype)
    if value.ndim == nd - 1:  # profile given without the keepdim axis
        value = jnp.expand_dims(value, axis)
    slab_shape = list(arr.shape)
    slab_shape[axis] = 1
    slab = jnp.broadcast_to(value, tuple(slab_shape))
    rest = [slice(None)] * nd
    if side == 0:
        rest[axis] = slice(1, None)
        return jnp.concatenate([slab, arr[tuple(rest)]], axis=axis)
    rest[axis] = slice(0, -1)
    return jnp.concatenate([arr[tuple(rest)], slab], axis=axis)


def apply_velocity_bcs(
    grid: GridSpec,
    bcs: BCTable,
    u: tuple[Array, ...],
    face_masks: Optional[tuple[Array, ...]] = None,
) -> tuple[Array, ...]:
    """Impose boundary values on the face-normal velocity DOFs.

    Sets the boundary faces of each component along its own axis (Dirichlet
    value for WALL/INFLOW, zero-gradient copy for OUTFLOW) and zeroes faces
    blocked by the obstacle mask. Tangential ghost values are not stored --
    they are reconstructed inside the stencils via :func:`pad_transverse`.
    """
    out = []
    for a, comp in enumerate(u):
        if bcs[(a, 0)].kind is BCKind.PERIODIC:
            # Faces 0 and n are the same physical face; the predictor/
            # corrector update face 0 with wrap stencils -- mirror it.
            comp = _set_face(comp, a, 1, _face_slice(comp, a, slice(0, 1)))
        else:
            for side, inner in ((0, slice(1, 2)), (1, slice(-2, -1))):
                bc = bcs[(a, side)]
                if bc.kind in _DIRICHLET_KINDS:
                    val = bc.component(a, grid.ndim)
                    comp = _set_face(comp, a, side, val)
                elif bc.kind is BCKind.OUTFLOW:
                    comp = _set_face(
                        comp, a, side, _face_slice(comp, a, inner)
                    )
                elif bc.kind is BCKind.CONVECTIVE:
                    # face value is owned by apply_convective_outlets
                    # (written onto u* before the projection and held fixed
                    # through it); this pass leaves it untouched
                    pass
                else:  # pragma: no cover - enum is closed
                    raise NotImplementedError(bc.kind)
        if face_masks is not None:
            comp = comp * face_masks[a]
        out.append(comp)
    return tuple(out)


def pad_transverse(
    grid: GridSpec, bcs: BCTable, comp: int, arr: Array
) -> Array:
    """Ghost-pad velocity component ``comp`` by one cell along every axis
    except its own staggering axis.

    WALL/INFLOW: ``ghost = 2*u_bc - edge`` (reflection through the Dirichlet
    wall value). OUTFLOW: ``ghost = edge`` (zero gradient). Along ``comp``'s
    own axis the boundary DOFs are already in-array, so no padding is needed
    (callers slice interior faces directly).
    """
    for t in range(grid.ndim):
        if t == comp:
            continue
        lo_bc = bcs[(t, 0)]
        hi_bc = bcs[(t, 1)]
        if lo_bc.kind is BCKind.PERIODIC:
            ghost_lo = _face_slice(arr, t, slice(-1, None))
            ghost_hi = _face_slice(arr, t, slice(0, 1))
            arr = jnp.concatenate([ghost_lo, arr, ghost_hi], axis=t)
            continue
        edge_lo = _face_slice(arr, t, slice(0, 1))
        edge_hi = _face_slice(arr, t, slice(-1, None))
        if lo_bc.kind in _TANGENTIAL_REFLECT_KINDS:
            val = jnp.asarray(lo_bc.component(comp, grid.ndim), grid.dtype)
            ghost_lo = 2.0 * val - edge_lo
        else:
            ghost_lo = edge_lo
        if hi_bc.kind in _TANGENTIAL_REFLECT_KINDS:
            val = jnp.asarray(hi_bc.component(comp, grid.ndim), grid.dtype)
            ghost_hi = 2.0 * val - edge_hi
        else:
            ghost_hi = edge_hi
        ghost_lo = jnp.broadcast_to(ghost_lo, edge_lo.shape)
        ghost_hi = jnp.broadcast_to(ghost_hi, edge_hi.shape)
        arr = jnp.concatenate([ghost_lo, arr, ghost_hi], axis=t)
    return arr


def apply_convective_outlets(
    grid: GridSpec,
    bcs: BCTable,
    u_new: tuple[Array, ...],
    u_old: tuple[Array, ...],
    dt,
) -> tuple[Array, ...]:
    """Once-per-step convective-outlet update of the boundary-normal DOFs:

        u_b_new = u_b^n - C (u_b^n - u_inner),   C = U dt / h

    (first-order upwind transport of the boundary value out of the domain;
    C is clamped to [0, 1] for unconditional stability). Called on u* right
    after the predictor -- the outlet face is then held FIXED through the
    projection (the other BC passes skip CONVECTIVE faces), exactly like
    the zero-gradient outlet's structure, so the post-projection divergence
    at outlet cells stays at the same small level."""
    out = list(u_new)
    for a in range(grid.ndim):
        for side, inner in ((0, slice(1, 2)), (1, slice(-2, -1))):
            bc = bcs[(a, side)]
            if bc.kind is not BCKind.CONVECTIVE:
                continue
            # speed may be a TRACED scalar (a time-dependent phase speed
            # resolved inside jit) -- keep it symbolic; dt may be traced
            # too (CFL-adaptive mode / inside scan)
            speed = bc.velocity[0] if bc.velocity else 1.0
            c = jnp.clip(
                jnp.asarray(speed) * jnp.asarray(dt) / grid.spacing[a],
                0.0, 1.0,
            )
            comp_old = u_old[a]
            u_b = _face_slice(comp_old, a, slice(0, 1) if side == 0 else slice(-1, None))
            u_i = _face_slice(out[a], a, inner)
            new_face = u_b - c * (u_b - u_i)
            out[a] = _set_face(out[a], a, side, new_face)
    return tuple(out)


def correct_convective_faces(
    grid: GridSpec,
    bcs: BCTable,
    u: tuple[Array, ...],
    p: Array,
    scale,
) -> tuple[Array, ...]:
    """Pressure-correct the convective outlet faces with the Dirichlet-ghost
    gradient the Poisson operator assumed (ghost p = -p_edge, so the face
    gradient is -2 p_edge / h on a high face and +2 p_edge / h on a low
    face). Without this the outlet-cell divergence retains a
    scale * 2 p_edge / h^2 residue; with it the projection closes exactly,
    matching the interior divergence level."""
    out = list(u)
    nd = grid.ndim
    for a in range(nd):
        h = grid.spacing[a]
        for side in (0, 1):
            if bcs[(a, side)].kind is not BCKind.CONVECTIVE:
                continue
            edge = _face_slice(
                p, a, slice(0, 1) if side == 0 else slice(-1, None)
            )
            grad = (2.0 * edge / h) if side == 0 else (-2.0 * edge / h)
            face = _face_slice(
                out[a], a, slice(0, 1) if side == 0 else slice(-1, None)
            )
            out[a] = _set_face(out[a], a, side, face - scale * grad)
    return tuple(out)


def has_convective_outlet(grid: GridSpec, bcs: BCTable) -> bool:
    return any(
        bcs[(a, s)].kind is BCKind.CONVECTIVE
        for a in range(grid.ndim) for s in (0, 1)
    )


# ---------------------------------------------------------------------------
# Obstacle masks
# ---------------------------------------------------------------------------


def face_masks_from_solid(
    grid: GridSpec,
    solid: Optional[np.ndarray],
    periodic: Optional[tuple[bool, ...]] = None,
) -> Optional[tuple[Array, ...]]:
    """Per-component face masks (1 = open, 0 = blocked) from a solid-cell mask.

    A face is blocked if *any* adjacent cell is solid (no-slip on obstacle
    surfaces, first-order immersed boundary). Boundary faces follow their
    single adjacent cell; along a periodic axis the boundary face wraps (its
    two adjacent cells are cell n-1 and cell 0).
    """
    if solid is None:
        return None
    per = periodic or (False,) * grid.ndim
    fluid = np.logical_not(np.asarray(solid, bool))
    if fluid.shape != grid.shape:
        raise ValueError(f"solid mask shape {fluid.shape} != grid {grid.shape}")
    masks = []
    for a in range(grid.ndim):
        m = np.ones(grid.face_shape(a), dtype=bool)
        lo = [slice(None)] * grid.ndim
        hi = [slice(None)] * grid.ndim
        mid = [slice(None)] * grid.ndim
        lo[a] = slice(0, -1)
        hi[a] = slice(1, None)
        mid[a] = slice(1, -1)
        m[tuple(mid)] = fluid[tuple(lo)] & fluid[tuple(hi)]
        first = [slice(None)] * grid.ndim
        last = [slice(None)] * grid.ndim
        first[a] = 0
        last[a] = -1
        cf = [slice(None)] * grid.ndim
        cl = [slice(None)] * grid.ndim
        cf[a] = 0
        cl[a] = -1
        if per[a]:
            wrap = fluid[tuple(cf)] & fluid[tuple(cl)]
            m[tuple(first)] = wrap
            m[tuple(last)] = wrap
        else:
            m[tuple(first)] = fluid[tuple(cf)]
            m[tuple(last)] = fluid[tuple(cl)]
        masks.append(jnp.asarray(m, grid.dtype))
    return tuple(masks)


def correction_face_masks(
    grid: GridSpec,
    solid: Optional[np.ndarray],
    periodic: Optional[tuple[bool, ...]] = None,
) -> Optional[tuple[Array, ...]]:
    """Masks for the pressure-gradient velocity correction on *interior* faces.

    Only faces between two fluid cells are corrected (solid cells hold a dummy
    p=0 that must not leak into the velocity). Shapes match the face slabs
    used by the corrector: component ``a`` -> ``grid.shape - e_a`` for a
    bounded axis, ``grid.shape`` (all n wrap faces) for a periodic one.
    """
    if solid is None:
        return None
    per = periodic or (False,) * grid.ndim
    fluid = np.logical_not(np.asarray(solid, bool))
    masks = []
    for a in range(grid.ndim):
        if per[a]:
            masks.append(jnp.asarray(
                np.roll(fluid, 1, axis=a) & fluid, grid.dtype
            ))
            continue
        lo = [slice(None)] * grid.ndim
        hi = [slice(None)] * grid.ndim
        lo[a] = slice(0, -1)
        hi[a] = slice(1, None)
        masks.append(jnp.asarray(fluid[tuple(lo)] & fluid[tuple(hi)], grid.dtype))
    return tuple(masks)
