"""Pressure Poisson operator and iterative solvers.

Capability parity: the reference's pressure projection step with Jacobi,
Gauss-Seidel and SOR relaxation (SURVEY.md SS2, [VERIFIED-DRIVER]
"Jacobi/Gauss-Seidel/SOR in the reference"), plus the driver-mandated
matrix-free CG upgrade "with the same convergence semantics".

Design notes:
  * All boundary conditions and obstacle masks are *folded into static
    per-cell data* built once per case (Neumann at walls/inflow and at
    fluid/solid faces; homogeneous Dirichlet at outflow faces). The inner
    iteration is then a single unmasked 5/7-point stencil -- no branching,
    fully fusible by XLA.
  * The neighbor-coupling coefficients are **compressed to one uint8 "stencil
    code" per cell** (one presence bit per face + a fluid bit) and decoded on
    the fly inside the stencil fusions: a coupling is either ``1/h_a^2`` or 0,
    so streaming six f32 coefficient arrays from HBM (the dominant traffic of
    a relaxation sweep -- these loops are bandwidth-bound) is replaced by one
    uint8 array at 1/24th the bytes. ``diag`` stays a real f32/f64 array
    because outflow faces add ``-2/h_a^2`` terms that don't fit a presence
    bit. Red-black parity masks are likewise synthesized from ``iota``
    instead of streamed.
  * Gauss-Seidel/SOR use *red-black* coloring -- the parallelizable ordering
    with the same fixed point as the reference's (presumably lexicographic)
    sweeps; per-iteration trajectories differ, converged states match
    (SURVEY.md SS2 note).
  * Stopping criterion (pinned choice, SURVEY.md SS0.3 TODO): relative L2
    residual ``||b - A p||_2 / max(||b||_2, tiny) <= tol``, identical across
    all four methods so "Poisson iters to fixed residual" is comparable.
  * Pure-Neumann problems (e.g. the closed cavity) are singular; the RHS and
    iterates are deflated by their fluid-cell mean, pinning the constant mode.
  * Everything runs inside ``lax.while_loop`` under jit: no host round-trips;
    under sharding, the norm reductions lower to ``psum`` over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..bcs import BCKind, BCTable
from ..grid import GridSpec

Array = jax.Array

# stencil-code bit layout: bit 2a = coupling to the low neighbor along axis a,
# bit 2a+1 = coupling to the high neighbor; bit 6 = cell is fluid.
FLUID_BIT = 6


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PoissonOp:
    """Matrix-free masked Laplacian ``A p = diag*p + sum_d c_d * p_neighbor_d``.

    ``code`` packs the neighbor-coupling presence bits (coupling value is the
    static ``w[a] = 1/h_a^2`` when present, zero across Neumann/solid faces)
    and the fluid mask; ``diag`` is the exact diagonal (including outflow
    Dirichlet-ghost terms). ``singular`` marks a pure-Neumann (nullspace =
    constants) problem.
    """

    diag: Array
    code: Array                      # uint8, same shape as diag
    w: tuple[float, ...]             # per-axis coupling 1/h_a^2
    singular: bool
    inv_fluid_count: float
    # Wrap-around neighbor topology per axis (periodic BCs): the neighbor
    # shifts in _neighbor_sum become rolls there.
    periodic: tuple[bool, ...] = ()
    # Cut-cell face apertures (cutcell.py sharp-interface pressure): per
    # axis, the FULL face array of fluid-open fractions in [0, 1]. When
    # set, couplings become w[a] * alpha_f (still symmetric -- the face is
    # shared) and the divergence/RHS must use the same apertured fluxes
    # (stencils.divergence with ap). None = staircase presence bits.
    ap: Optional[tuple[Array, ...]] = None

    def tree_flatten(self):
        return (
            (self.diag, self.code, self.ap),
            (self.w, self.singular, self.inv_fluid_count, self.periodic),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        diag, code, ap = children
        return cls(diag, code, aux[0], aux[1], aux[2], aux[3], ap)

    # -- decoded views (fused into consumers under jit; never HBM-resident) --

    @property
    def fluid(self) -> Array:
        return ((self.code >> FLUID_BIT) & 1).astype(self.diag.dtype)

    def _coef(self, axis: int, side: int) -> Array:
        bit = 2 * axis + side
        present = ((self.code >> bit) & 1).astype(self.diag.dtype)
        return self.w[axis] * present

    @property
    def lo(self) -> tuple[Array, ...]:
        return tuple(self._coef(a, 0) for a in range(len(self.w)))

    @property
    def hi(self) -> tuple[Array, ...]:
        return tuple(self._coef(a, 1) for a in range(len(self.w)))


def build_poisson_op(
    grid: GridSpec, bcs: BCTable, solid: Optional[np.ndarray] = None
) -> PoissonOp:
    """Build the static stencil code + diagonal for the pressure Poisson eq.

    Per axis ``a`` and side, the coupling across a face is ``1/h_a^2`` when
    the neighbor is a fluid cell; 0 across domain walls/inflow and solid
    neighbors (Neumann dp/dn = 0); outflow faces contribute ``-2/h_a^2`` to
    the diagonal (ghost ``p = -p`` so the face value is 0). Solid cells get
    the identity row (p pinned to 0 there).
    """
    nd = grid.ndim
    h = grid.spacing
    periodic = tuple(
        bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(nd)
    )
    fluid = np.ones(grid.shape, dtype=bool)
    if solid is not None:
        fluid &= np.logical_not(np.asarray(solid, bool))

    diag = np.zeros(grid.shape, dtype=np.float64)
    code = np.zeros(grid.shape, dtype=np.uint8)
    code |= fluid.astype(np.uint8) << FLUID_BIT
    w = []
    for a in range(nd):
        wa = 1.0 / (h[a] * h[a])
        w.append(float(wa))

        def shifted(side: int) -> np.ndarray:
            """Whether the neighbor on `side` along axis a exists and is fluid."""
            if periodic[a]:
                return np.roll(fluid, 1 if side == 0 else -1, axis=a)
            nb = np.zeros(grid.shape, dtype=bool)
            src = [slice(None)] * nd
            dst = [slice(None)] * nd
            if side == 0:
                dst[a] = slice(1, None)
                src[a] = slice(0, -1)
            else:
                dst[a] = slice(0, -1)
                src[a] = slice(1, None)
            nb[tuple(dst)] = fluid[tuple(src)]
            return nb

        lo = shifted(0) & fluid
        hi = shifted(1) & fluid
        code |= lo.astype(np.uint8) << (2 * a)
        code |= hi.astype(np.uint8) << (2 * a + 1)
        # Domain-boundary cells: outflow face => Dirichlet p=0 ghost.
        for side in (0, 1):
            face = [slice(None)] * nd
            face[a] = 0 if side == 0 else -1
            if bcs[(a, side)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE):
                diag[tuple(face)] -= 2.0 * wa
            # WALL/INFLOW: Neumann -> no coupling, no diagonal contribution.
        diag -= wa * (lo.astype(np.float64) + hi.astype(np.float64))

    # Solid cells: identity row.
    diag[~fluid] = 1.0

    singular = not any(
        bcs[(a, s)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        for a in range(nd) for s in (0, 1)
    )
    dt = grid.dtype
    return PoissonOp(
        diag=jnp.asarray(diag, dt),
        code=jnp.asarray(code),
        w=tuple(w),
        singular=singular,
        inv_fluid_count=float(1.0 / fluid.sum()),
        periodic=periodic,
    )


def build_poisson_op_cut(
    grid: GridSpec, bcs: BCTable, ap, fluid: np.ndarray
) -> PoissonOp:
    """Cut-cell (apertured) pressure Poisson operator (cutcell.py).

    ``ap``: per-axis full face-aperture arrays from cutcell.cut_geometry
    (faces across/into solid cells already closed there). Couplings are
    ``w[a] * alpha_f`` on interior faces -- symmetric, since the two cells
    share the face; domain faces are Neumann (no coupling) except
    OUTFLOW/CONVECTIVE, whose Dirichlet-ghost term scales with the face
    aperture. Solid cells keep identity rows.
    """
    nd = grid.ndim
    h = grid.spacing
    if any(bcs[(a, 0)].kind is BCKind.PERIODIC for a in range(nd)):
        raise ValueError("cut-cell pressure + periodic axes not supported")
    fluid = np.asarray(fluid, bool)
    diag = np.zeros(grid.shape, dtype=np.float64)
    code = np.zeros(grid.shape, dtype=np.uint8)
    code |= fluid.astype(np.uint8) << FLUID_BIT
    w = []
    for a in range(nd):
        wa = 1.0 / (h[a] * h[a])
        w.append(float(wa))
        al = np.asarray(ap[a], np.float64)
        lo_c = np.zeros(grid.shape)   # coupling to the low neighbor
        hi_c = np.zeros(grid.shape)
        lo_sl = [slice(None)] * nd
        lo_sl[a] = slice(1, None)     # cells 1..n-1 couple through face i
        in_f = [slice(None)] * nd
        in_f[a] = slice(1, -1)        # interior faces 1..n-1
        lo_c[tuple(lo_sl)] = al[tuple(in_f)]
        hi_sl = [slice(None)] * nd
        hi_sl[a] = slice(0, -1)
        hi_c[tuple(hi_sl)] = al[tuple(in_f)]
        code |= (lo_c > 0).astype(np.uint8) << (2 * a)
        code |= (hi_c > 0).astype(np.uint8) << (2 * a + 1)
        diag -= wa * (lo_c + hi_c)
        for side in (0, 1):
            if bcs[(a, side)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE):
                face = [slice(None)] * nd
                face[a] = 0 if side == 0 else -1
                bf = [slice(None)] * nd
                bf[a] = 0 if side == 0 else -1
                diag[tuple(face)] -= 2.0 * wa * al[tuple(bf)]
    diag[~fluid] = 1.0
    singular = not any(
        bcs[(a, s)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        for a in range(nd) for s in (0, 1)
    )
    dt = grid.dtype
    return PoissonOp(
        diag=jnp.asarray(diag, dt),
        code=jnp.asarray(code),
        w=tuple(w),
        singular=singular,
        inv_fluid_count=float(1.0 / fluid.sum()),
        periodic=(False,) * nd,
        ap=tuple(jnp.asarray(np.asarray(x, np.float64), dt) for x in ap),
    )


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Distribution context: run the SAME solver bodies inside a shard_map
    block (SURVEY.md SS5 "the halo exchange IS the ring").

    One implementation, two modes (VERDICT r1 item 4 -- the explicit
    halo-exchange solver must not fork the convergence semantics): with
    ``ctx=None`` every function below is the plain single-device math; with
    a ctx, neighbor fetches along sharded axes become ``ppermute`` ghost
    slabs over ICI (wraparound ring ends on periodic axes), reductions
    become ``psum`` over the mesh axes, and red-black parity picks up the
    shard's global offset.

    axes:  per grid axis, the mesh axis name it is sharded over (None =
           locally resident).
    sizes: devices per grid axis (1 where unsharded).
    """

    axes: tuple
    sizes: tuple

    @property
    def names(self) -> tuple:
        return tuple(n for n in self.axes if n is not None)

    def psum(self, x):
        names = self.names
        return jax.lax.psum(x, names) if names else x

    def parity_offset(self, local_shape):
        off = jnp.int32(0)
        for a, name in enumerate(self.axes):
            if name is not None:
                off = off + jax.lax.axis_index(name).astype(jnp.int32) * (
                    local_shape[a]
                )
        return off

    def ghosts(self, p: Array, a: int, periodic: bool):
        """(lo, hi) ghost slabs along grid axis ``a`` from the ring
        neighbors. Non-periodic ring ends receive zeros (their coupling
        bits are cleared in the stencil code, so the content is multiplied
        by zero); periodic axes close the ring with a wraparound link."""
        name = self.axes[a]
        n = self.sizes[a]
        nd = p.ndim
        lo_sl = [slice(None)] * nd
        lo_sl[a] = slice(0, 1)
        hi_sl = [slice(None)] * nd
        hi_sl[a] = slice(-1, None)
        fwd = [(k, k + 1) for k in range(n - 1)]
        bwd = [(k, k - 1) for k in range(1, n)]
        if periodic:
            fwd.append((n - 1, 0))
            bwd.append((0, n - 1))
        lo = jax.lax.ppermute(p[tuple(hi_sl)], name, fwd)
        hi = jax.lax.ppermute(p[tuple(lo_sl)], name, bwd)
        return lo, hi

    def sharded(self, a: int) -> bool:
        return self.axes[a] is not None and self.sizes[a] > 1


def _neighbor_sum(op: PoissonOp, p: Array, ctx: Optional[ShardCtx] = None) -> Array:
    """``sum_d c_d * p_neighbor_d``, coefficients decoded from the stencil
    code (select-then-scale: a masked-out neighbor contributes exactly 0,
    which also kills the zero-pad ghosts). With a ShardCtx, neighbors along
    sharded axes arrive as ppermute'd ghost slabs."""
    nd = p.ndim
    code = op.code
    periodic = op.periodic or (False,) * nd
    out = jnp.zeros_like(p)
    if op.ap is not None:
        # cut-cell couplings: w[a] * alpha on interior faces. The presence
        # bits already encode alpha > 0 AND both-cells-fluid (build), so
        # the zero-pad ghosts/boundary faces die through the where; the
        # aperture slices scale what survives. No ctx/periodic support
        # (build_poisson_op_cut rejects periodic; halo tier gates ap out).
        if ctx is not None and any(ctx.sharded(a) for a in range(nd)):
            raise NotImplementedError(
                "cut-cell apertures under the explicit-halo tier"
            )
        for a in range(nd):
            al = op.ap[a]
            sl = [slice(None)] * nd
            sl[a] = slice(0, -1)
            ap_lo = al[tuple(sl)]          # cell i's low face i
            sl[a] = slice(1, None)
            ap_hi = al[tuple(sl)]          # cell i's high face i+1
            pad_lo = [(0, 0)] * nd
            pad_lo[a] = (1, 0)
            pad_hi = [(0, 0)] * nd
            pad_hi[a] = (0, 1)
            sl_lo = [slice(None)] * nd
            sl_lo[a] = slice(0, -1)
            sl_hi = [slice(None)] * nd
            sl_hi[a] = slice(1, None)
            p_lo = jnp.pad(p, pad_lo)[tuple(sl_lo)]
            p_hi = jnp.pad(p, pad_hi)[tuple(sl_hi)]
            has_lo = (code & (1 << (2 * a))) > 0
            has_hi = (code & (1 << (2 * a + 1))) > 0
            zero = jnp.zeros((), p.dtype)
            out = out + op.w[a] * (
                jnp.where(has_lo, ap_lo * p_lo, zero)
                + jnp.where(has_hi, ap_hi * p_hi, zero)
            )
        return out
    for a in range(nd):
        if ctx is not None and ctx.sharded(a):
            gl, gr = ctx.ghosts(p, a, periodic[a])
            pad = jnp.concatenate([gl, p, gr], axis=a)
            sl_lo = [slice(None)] * nd
            sl_lo[a] = slice(0, -2)
            sl_hi = [slice(None)] * nd
            sl_hi[a] = slice(2, None)
            p_lo = pad[tuple(sl_lo)]
            p_hi = pad[tuple(sl_hi)]
            has_lo = (code & (1 << (2 * a))) > 0
            has_hi = (code & (1 << (2 * a + 1))) > 0
            zero = jnp.zeros((), p.dtype)
            out = out + op.w[a] * (
                jnp.where(has_lo, p_lo, zero) + jnp.where(has_hi, p_hi, zero)
            )
            continue
        if periodic[a]:
            p_lo = jnp.roll(p, 1, axis=a)
            p_hi = jnp.roll(p, -1, axis=a)
            has_lo = (code & (1 << (2 * a))) > 0
            has_hi = (code & (1 << (2 * a + 1))) > 0
            zero = jnp.zeros((), p.dtype)
            out = out + op.w[a] * (
                jnp.where(has_lo, p_lo, zero) + jnp.where(has_hi, p_hi, zero)
            )
            continue
        pad_lo = [(0, 0)] * nd
        pad_lo[a] = (1, 0)
        pad_hi = [(0, 0)] * nd
        pad_hi[a] = (0, 1)
        sl_lo = [slice(None)] * nd
        sl_lo[a] = slice(0, -1)
        sl_hi = [slice(None)] * nd
        sl_hi[a] = slice(1, None)
        p_lo = jnp.pad(p, pad_lo)[tuple(sl_lo)]   # neighbor at index-1
        p_hi = jnp.pad(p, pad_hi)[tuple(sl_hi)]   # neighbor at index+1
        has_lo = (code & (1 << (2 * a))) > 0
        has_hi = (code & (1 << (2 * a + 1))) > 0
        zero = jnp.zeros((), p.dtype)
        out = out + op.w[a] * (
            jnp.where(has_lo, p_lo, zero) + jnp.where(has_hi, p_hi, zero)
        )
    return out


def apply_A(op: PoissonOp, p: Array, ctx: Optional[ShardCtx] = None) -> Array:
    return op.diag * p + _neighbor_sum(op, p, ctx)


def deflate(op: PoissonOp, x: Array, ctx: Optional[ShardCtx] = None) -> Array:
    """Remove the constant nullspace component over fluid cells (singular case).

    ``op.inv_fluid_count`` is the GLOBAL reciprocal count, so under a ctx
    the psum'd local sums produce the global mean."""
    if not op.singular:
        return x
    fluid = op.fluid
    s = jnp.sum(x * fluid)
    if ctx is not None:
        s = ctx.psum(s)
    mean = s * op.inv_fluid_count
    return (x - mean) * fluid


def residual_norm(
    op: PoissonOp, p: Array, b: Array, ctx: Optional[ShardCtx] = None
) -> Array:
    r = (b - apply_A(op, p, ctx)) * op.fluid
    s = jnp.sum(r * r)
    if ctx is not None:
        s = ctx.psum(s)
    return jnp.sqrt(s)


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    method: str = "cg"          # "jacobi" | "gs" | "sor" | "cg"
                                 # (+ "mg" | "mgcg" | "fft", handled upstream
                                 #  by Simulation.build)
    tol: float = 1e-5            # relative L2 residual
    max_iters: int = 500
    omega: Optional[float] = None  # SOR relaxation; None -> auto-optimal
    check_every: int = 1         # residual check cadence for relaxation methods
    # Jacobi damping. Plain (w=1) Jacobi is *not convergent* for the pure-
    # Neumann pressure problem: the iteration matrix is row-stochastic on a
    # bipartite grid graph, so the checkerboard mode has eigenvalue exactly -1
    # and oscillates forever. Damping moves it to 1-2w; the fixed point (the
    # reference-fidelity converged state) is unchanged. w=1 restores the
    # textbook sweep for Dirichlet problems.
    jacobi_weight: float = 0.8
    # Report the exact post-solve residual in StepDiagnostics for DIRECT
    # (fft) solves. The iterative solvers compute it anyway for their
    # stopping rule; the direct solve needs an extra operator application +
    # norm reductions per step purely for reporting.
    # False -> diagnostics carry the sentinel -1.0 and callers that need
    # the number run one diagnostic step with it re-enabled.
    diag_residual: bool = True
    # Damped second-order warm start for the ITERATIVE solvers: seed each
    # step's solve with ``p_n + beta (p_n - p_{n-1})`` instead of ``p_n``
    # (the State then carries p_prev through the scan). The pressure field
    # evolves smoothly in time, so the extrapolated guess starts closer.
    # beta MUST stay < 1: the error recurrence e_{n+1} ~ (1+beta) e_n -
    # beta e_{n-1} has roots {1, beta} -- strictly stable second root --
    # while beta = 1 is a double root at 1 whose linearly-growing
    # uncorrected error compounds whenever the solver bails at its f32
    # residual floor instead of tol (observed: mg at 2048x1024 floors near
    # 2e-5 and full extrapolation NaN'd within 50 steps). 0.0 = off
    # (default: extrapolation perturbs the tolerance-equivalent trajectory,
    # which would invalidate the pinned golden files).
    extrapolate: float = 0.0


def _auto_omega(grid: GridSpec) -> float:
    """Textbook optimal SOR omega for the Laplacian on the coarsest axis."""
    n = min(grid.shape)
    import math

    return 2.0 / (1.0 + math.sin(math.pi / n))


def solve_poisson(
    op: PoissonOp,
    b: Array,
    p0: Array,
    grid: GridSpec,
    cfg: PoissonConfig,
    ctx: Optional[ShardCtx] = None,
) -> tuple[Array, Array, Array]:
    """Solve ``A p = b``; returns ``(p, iters, final_relative_residual)``.

    jit-safe: fixed-structure ``lax.while_loop`` with iteration cap. With a
    ``ShardCtx`` this same body runs distributed inside a shard_map block
    (parallel/halo.py): identical convergence semantics by construction --
    every device evaluates the same psum'd predicate, control flow stays
    lockstep with zero host round-trips.
    """
    dt = grid.dtype
    b = b * op.fluid
    b = deflate(op, b, ctx) if op.singular else b
    p0 = (p0 * op.fluid).astype(dt)
    bsq = jnp.sum(b * b)
    if ctx is not None:
        bsq = ctx.psum(bsq)
    bnorm = jnp.sqrt(bsq)
    tiny = jnp.asarray(np.finfo(np.float32).tiny, dt)
    inv_bnorm = 1.0 / jnp.maximum(bnorm, tiny)
    tol = jnp.asarray(cfg.tol, dt)

    if cfg.method == "cg":
        return _solve_cg(op, b, p0, inv_bnorm, tol, cfg.max_iters, ctx)
    if cfg.method in ("jacobi", "gs", "sor"):
        if cfg.method == "jacobi":
            w = cfg.jacobi_weight
            sweep = lambda p: _jacobi_sweep(op, p, b, w, ctx)
        else:
            omega = 1.0 if cfg.method == "gs" else (
                cfg.omega if cfg.omega is not None else _auto_omega(grid)
            )
            sweep = lambda p: _rb_sweep(op, p, b, omega, ctx=ctx)
        return _relaxation_loop(op, b, p0, sweep, inv_bnorm, tol, cfg, ctx)
    raise ValueError(f"unknown poisson method {cfg.method!r}")


def _jacobi_sweep(
    op: PoissonOp, p: Array, b: Array, weight: float = 1.0,
    ctx: Optional[ShardCtx] = None,
) -> Array:
    p_new = (b - _neighbor_sum(op, p, ctx)) / op.diag
    if weight != 1.0:
        p_new = (1.0 - weight) * p + weight * p_new
    return p_new * op.fluid


def _parity(shape: tuple[int, ...], offset=0) -> Array:
    """(i+j(+k)+offset) % 2 == 0 mask, synthesized from iota (never streamed
    from HBM). ``offset`` shifts to global parity inside shard_map blocks."""
    idx_sum = sum(
        jax.lax.broadcasted_iota(jnp.int32, shape, d) for d in range(len(shape))
    )
    return (idx_sum + offset) % 2 == 0


def _rb_masks(op: PoissonOp) -> tuple[Array, Array]:
    red = _parity(op.diag.shape).astype(op.diag.dtype)
    return red, 1.0 - red


def _rb_sweep(
    op: PoissonOp, p: Array, b: Array, omega: float, parity_offset=0,
    ctx: Optional[ShardCtx] = None,
) -> Array:
    if ctx is not None:
        parity_offset = parity_offset + ctx.parity_offset(p.shape)
    red = _parity(p.shape, parity_offset)
    fluid = op.fluid
    for is_red in (True, False):
        color = red if is_red else jnp.logical_not(red)
        gs = (b - _neighbor_sum(op, p, ctx)) / op.diag
        p_new = (1.0 - omega) * p + omega * gs
        p = jnp.where(color, p_new, p) * fluid
    return p


def _relaxation_loop(op, b, p0, sweep, inv_bnorm, tol, cfg, ctx=None):
    check = max(1, int(cfg.check_every))

    def cond(carry):
        p, k, res = carry
        return jnp.logical_and(k < cfg.max_iters, res > tol)

    def body(carry):
        p, k, _ = carry
        for _ in range(check):
            p = sweep(p)
        if op.singular:
            p = deflate(op, p, ctx)
        res = residual_norm(op, p, b, ctx) * inv_bnorm
        return p, k + check, res

    res0 = residual_norm(op, p0, b, ctx) * inv_bnorm
    p, iters, res = jax.lax.while_loop(cond, body, (p0, jnp.int32(0), res0))
    return p, iters, res


def _solve_cg(op, b, p0, inv_bnorm, tol, max_iters, ctx=None):
    """Matrix-free conjugate gradients on the masked Laplacian.

    The discrete Laplacian here is negative (semi-)definite, so CG runs on the
    negated system ``(-A) p = (-b)`` (SPD on the fluid subspace, with the
    constant mode deflated in the singular pure-Neumann case). Same convergence
    semantics as the relaxation solvers: terminates on the relative L2 residual
    of ``b - A p``, whose norm equals that of the negated recurrence residual.
    """

    def dot(x, y):
        s = jnp.sum(x * y)
        return ctx.psum(s) if ctx is not None else s

    def matvec(x):
        ax = -apply_A(op, x, ctx) * op.fluid
        return deflate(op, ax, ctx) if op.singular else ax

    b = -b
    r0 = (b - matvec(p0)) * op.fluid
    r0 = deflate(op, r0, ctx) if op.singular else r0
    d0 = r0
    rs0 = dot(r0, r0)

    def cond(carry):
        p, r, d, rs, k, ok = carry
        return jnp.logical_and(
            ok,
            jnp.logical_and(k < max_iters,
                            jnp.sqrt(rs) * inv_bnorm > tol),
        )

    def body(carry):
        p, r, d, rs, k, _ = carry
        Ad = matvec(d)
        dAd = dot(d, Ad)
        # Curvature-breakdown guard: when the search direction degrades
        # to f32 noise (tol below the achievable floor on a badly
        # conditioned operator -- e.g. strongly anisotropic spacing),
        # d.Ad can round NEGATIVE; the old max(dAd, 1e-30) clamp then
        # produced alpha ~ rs/1e-30 -> overflow -> NaN fields with the
        # loop exiting on the NaN compare. Instead: take no step and
        # STOP, reporting the last true residual (the solve is at its
        # f32 floor; callers' CAPPED labeling applies).
        ok = dAd > jnp.asarray(0.0, d.dtype)
        alpha = jnp.where(
            ok, rs / jnp.maximum(dAd, jnp.asarray(1e-30, d.dtype)), 0.0
        )
        p = p + alpha * d
        r = r - alpha * Ad
        rs_new = dot(r, r)
        beta = jnp.where(
            ok, rs_new / jnp.maximum(rs, jnp.asarray(1e-30, d.dtype)), 0.0
        )
        d = r + beta * d
        return p, r, d, rs_new, k + 1, ok

    p, r, d, rs, iters, _ = jax.lax.while_loop(
        cond, body, (p0, r0, d0, rs0, jnp.int32(0), jnp.bool_(True))
    )
    if op.singular:
        p = deflate(op, p, ctx)
    return p, iters, jnp.sqrt(rs) * inv_bnorm


def flexible_pcg(
    op: PoissonOp,
    b: Array,
    p0: Array,
    tol,
    max_iters: int,
    precond,
    ctx: Optional[ShardCtx] = None,
) -> tuple[Array, Array, Array]:
    """Flexible (Polak-Ribiere) preconditioned CG -- ONE implementation
    shared by every preconditioner (multigrid V-cycle in
    ops/multigrid.solve_pcg, spectral DCT inverse in
    ops/fft_poisson.DCTPCGSolver); VERDICT r1 item 4's no-forked-semantics
    rule applied to Krylov solvers.

    Runs on the negated system ``(-A) p = -b`` (SPD on the fluid subspace,
    constant mode deflated when singular), like ``_solve_cg``.
    ``precond(r)`` must approximate ``(-A)^{-1} r``; it may be inexact and
    even nonsymmetric (an RB-smoothed V-cycle, a reduced-precision transform chain) --
    the flexible beta ``z_new.(r_new - r)/(z.r)`` keeps CG convergent where
    standard PCG would stall. Stopping semantics match every other solver
    here: relative L2 of ``b - A p``; iters are CG iterations.
    """
    dt = b.dtype
    b = b * op.fluid
    b = deflate(op, b, ctx) if op.singular else b
    p0 = p0 * op.fluid
    bsq = jnp.sum(b * b)
    if ctx is not None:
        bsq = ctx.psum(bsq)
    bnorm = jnp.sqrt(bsq)
    tiny = jnp.asarray(np.finfo(np.float32).tiny, dt)
    inv_bnorm = 1.0 / jnp.maximum(bnorm, tiny)
    tol = jnp.asarray(tol, dt)

    def dot(x, y):
        s = jnp.sum(x * y)
        return ctx.psum(s) if ctx is not None else s

    def matvec(x):
        ax = -apply_A(op, x, ctx) * op.fluid
        return deflate(op, ax, ctx) if op.singular else ax

    nb = -b
    r0 = (nb - matvec(p0)) * op.fluid
    r0 = deflate(op, r0, ctx) if op.singular else r0
    z0 = precond(r0)
    d0 = z0
    rz0 = dot(r0, z0)
    res0 = jnp.sqrt(dot(r0, r0)) * inv_bnorm

    # Float32-floor guard: CG residuals are not monotone, so a plain
    # "res > 0.9*prev" stagnation check would false-trigger. Instead carry
    # the best iterate seen and bail after `PATIENCE` consecutive
    # iterations without a 5% improvement -- a tol below the f32 residual
    # floor then costs a few extra iterations, not max_iters every step.
    # Past the floor the recurrence quantities (rz, d.Ad) degenerate and
    # can NaN; NaN compares false everywhere, so `best_*` freezes at the
    # last finite improvement and that iterate is what gets returned.
    PATIENCE = jnp.int32(5)

    def cond(carry):
        p, r, z, d, rz, k, best_res, best_p, since = carry
        return jnp.logical_and(
            jnp.logical_and(k < max_iters, best_res > tol),
            since < PATIENCE,
        )

    def body(carry):
        p, r, z, d, rz, k, best_res, best_p, since = carry
        Ad = matvec(d)
        alpha = rz / jnp.maximum(dot(d, Ad), jnp.asarray(1e-30, dt))
        p = p + alpha * d
        r_new = r - alpha * Ad
        z_new = precond(r_new)
        # flexible beta: z_new . (r_new - r) / (z . r)
        beta = dot(z_new, r_new - r) / jnp.maximum(
            rz, jnp.asarray(1e-30, dt)
        )
        beta = jnp.maximum(beta, 0.0)   # restart direction if negative
        d = z_new + beta * d
        rz_new = dot(r_new, z_new)
        res = jnp.sqrt(dot(r_new, r_new)) * inv_bnorm
        better = res < best_res          # False for NaN res
        best_p = jnp.where(better, p, best_p)
        improved = res < 0.95 * best_res
        best_res = jnp.where(better, res, best_res)
        since = jnp.where(improved, jnp.int32(0), since + 1)
        return p, r_new, z_new, d, rz_new, k + 1, best_res, best_p, since

    _, r, z, d, rz, iters, res, p, _ = jax.lax.while_loop(
        cond, body,
        (p0, r0, z0, d0, rz0, jnp.int32(0), res0, p0, jnp.int32(0)),
    )
    if op.singular:
        p = deflate(op, p, ctx)
    return p, iters, res
