"""Direct spectral (DCT) pressure Poisson solver.

Upgrade beyond the reference's relaxation solvers (SURVEY.md SS2
mandates "matrix-free CG with the same convergence semantics"; this goes
further): for obstacle-free rectangular domains the discrete Laplacian
diagonalizes under a per-axis tensor basis chosen from the BCs -- DCT-II on
Neumann/Neumann axes (walls/inflow/slip), circulant FFT on periodic axes,
and DCT-IV / mixed bases on axes with a Dirichlet (outflow) end (see
``axis_kinds_from_bcs``) -- so the projection solve is EXACT in one
application: forward transform per axis, divide by eigenvalue sums, inverse
transform. No iteration, no convergence question -- residual is reported
post-hoc in the same relative-L2 norm as the iterative solvers.

Falls back unavailable (is_applicable() False) only when an obstacle mask
is present; Simulation then uses the iterative path (where ``dctcg`` can
still use these bases as a capacitance-corrected preconditioner).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..bcs import BCKind, BCTable
from ..grid import GridSpec
from . import dct as dct_mod
from .poisson import PoissonOp, apply_A, residual_norm

Array = jax.Array


def axis_kinds_from_bcs(grid: GridSpec, bcs: BCTable) -> tuple[str, ...]:
    """Per-axis transform kind for the pressure operator's eigenbasis.

    ops/poisson.py gives every face one of two ghost symmetries: even
    (ghost = edge; wall/inflow/slip -> Neumann) or odd (ghost = -edge;
    outflow/convective -> Dirichlet p=0 at the face). Each (lo, hi)
    combination diagonalizes under a classical trigonometric transform
    (ops/dct.py mixed-BC section):
      'nn' DCT-II | 'nd' DCT-IV | 'dn' flipped DCT-IV | 'dd' DST-II |
      'per' circulant eigenbasis.
    """
    kinds = []
    for a in range(grid.ndim):
        if bcs[(a, 0)].kind is BCKind.PERIODIC:
            kinds.append("per")
            continue
        lo_d = bcs[(a, 0)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        hi_d = bcs[(a, 1)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
        kinds.append({(False, False): "nn", (False, True): "nd",
                      (True, False): "dn", (True, True): "dd"}[(lo_d, hi_d)])
    return tuple(kinds)


def is_applicable(grid: GridSpec, bcs: BCTable, solid) -> bool:
    """Every face symmetry (Neumann, Dirichlet-outflow, periodic) has an
    exact eigenbasis now; only an interior obstacle mask breaks the tensor
    structure (use the iterative solvers or the DCT-preconditioned CG)."""
    return solid is None or not np.any(solid)


@dataclasses.dataclass(eq=False)
class DCTPoissonSolver:
    """Precomputed inverse-eigenvalue tensor for the diagonalizable Laplacian.

    ``mode="matmul"`` (default) applies the per-axis transforms as (radix-
    split) dense matmul chains. ``mode="fft"`` keeps an O(n log n) path
    (non-periodic axes only).
    """

    grid: GridSpec
    inv_eig: Array  # 1/(sum_a lambda_a(k_a)), 0 at the k=0...0 constant mode
    # Per-axis radix-split transform plans (matmul mode). levels=0 degrades
    # to the dense DCT matmul; levels=L halves the MACs per level via the
    # exact symmetric-fold split (dct.SplitPlan -- stable, no Lee scalings).
    plans: tuple[object, ...] = ()
    mode: str = "matmul"
    # Matmul precision of the main transform chain. A direct solve plus
    # `refine` residual-correction passes through the same solver
    # (iterative refinement) lands the residual near the f32 floor: the
    # refinement residual uses the exact f32 stencil operator, so accuracy
    # is governed by the correction -- as long as the transform error
    # stays well below 1, or the correction diverges. "highest" (full
    # f32): on an H100 "high" runs the transforms in TF32, whose ~1e-3
    # error fails the build-time self-check at 2048^2 and leaves the 256^3
    # refined residual at 2.7e-5, above the 1e-5 contract (PERF.md).
    precision: str = "highest"
    refine: int = 1
    # Matmul precision of the REFINEMENT direct solves only (the
    # correction's transform error multiplies the already-small residual
    # correction, not the solution).
    refine_precision: str = "highest"
    # Per-axis eigenbasis kind ('nn'|'nd'|'dn'|'dd'|'per'); see
    # axis_kinds_from_bcs. All-'nn'/'per' is the singular (pure-Neumann)
    # problem with the constant mode pinned; any Dirichlet axis makes the
    # operator nonsingular and the solve exact at every mode.
    kinds: tuple[str, ...] = ()

    @property
    def singular(self) -> bool:
        return all(k in ("nn", "per") for k in (self.kinds or ()))

    @staticmethod
    def build(
        grid: GridSpec,
        mode: str = "matmul",
        precision: str = "highest",
        refine: int = 1,
        split_levels: Optional[int] = None,
        periodic: Optional[tuple[bool, ...]] = None,
        kinds: Optional[tuple[str, ...]] = None,
        self_check: bool = True,
        _force_dense: bool = False,
    ) -> "DCTPoissonSolver":
        if kinds is None:
            periodic = periodic or (False,) * grid.ndim
            kinds = tuple("per" if p else "nn" for p in periodic)
        else:
            periodic = tuple(k == "per" for k in kinds)
        if any(k != "nn" for k in kinds) and mode != "matmul":
            raise ValueError(
                "periodic/Dirichlet axes require mode='matmul'"
            )
        qmats = {}
        lam = []
        for a, (n, h) in enumerate(zip(grid.shape, grid.spacing)):
            k = kinds[a]
            if k == "per":
                Q, l = dct_mod.circulant_eigenbasis(n, h)
                qmats[a] = Q
                lam.append(l)   # eigenvalues in Q-column order
            elif k == "nn":
                lam.append(dct_mod.neumann_eigenvalues(n, h))
            elif k in ("nd", "dn"):
                lam.append(dct_mod.mixed_nd_eigenvalues(n, h))
            elif k == "dd":
                lam.append(dct_mod.dirichlet_eigenvalues(n, h))
            else:
                raise ValueError(f"unknown axis kind {k!r}")
        total = np.zeros(grid.shape, dtype=np.float64)
        for a, l in enumerate(lam):
            shape = [1] * grid.ndim
            shape[a] = grid.shape[a]
            total = total + l.reshape(shape)
        inv = np.zeros_like(total)
        nz = total != 0.0
        inv[nz] = 1.0 / total[nz]  # constant mode pinned to 0 (deflation)
        plans = ()
        if mode == "matmul":
            # Auto depth: the split is exact/stable, so depth only trades
            # matmul MACs (halved per level) against butterfly passes.
            # Default keeps the base matmul >= 128 and <= 4 levels;
            # NSTPU_SPLIT_LEVELS overrides for tuning.
            if split_levels is None:
                import os

                env = os.environ.get("NSTPU_SPLIT_LEVELS")
                split_levels = int(env) if env else None
            # Splitting only for large transforms (n >= 1024): below that
            # the butterflies' extra passes outweigh the saved MACs.
            def _auto_levels(n):
                if n < 1024:
                    return 0
                return min(4, dct_mod.split_levels(n, min_base=128))

            def _plan(a, n):
                k = kinds[a]
                if k == "per":
                    # symmetric-fold circulant split (2x MACs) pays at the
                    # same scale threshold as the DCT split
                    if n >= 1024 and n % 2 == 0 and not _force_dense:
                        return dct_mod.CircSplitPlan(n, grid.dtype)
                    return dct_mod.DensePlan(qmats[a].T, qmats[a], grid.dtype)
                if k in ("nd", "dn"):
                    # DCT-IV axes: one-level even-odd butterfly split
                    # (Dct4SplitPlan) halves the MACs of the dense n x n
                    # matmul, which dominates the dctcg preconditioner.
                    if n % 2 == 0 and n >= 512 and not _force_dense:
                        return dct_mod.Dct4SplitPlan(
                            n, grid.dtype, flipped=(k == "dn")
                        )
                    C = dct_mod.dct4_matrix(n)
                    if k == "dn":
                        C = C[:, ::-1]
                    return dct_mod.DensePlan(C, C.T, grid.dtype)
                if k == "dd":
                    # double-outflow axes are rare; dense is fine
                    C = dct_mod.dst2_matrix(n)
                    return dct_mod.DensePlan(C, C.T, grid.dtype)
                lv = _auto_levels(n) if split_levels is None else split_levels
                if _force_dense:
                    lv = 0
                return dct_mod.SplitPlan(n, lv, grid.dtype)

            plans = tuple(_plan(a, n) for a, n in enumerate(grid.shape))
            # Spectral multiplier stored in REVERSED axis order: the matmul
            # chain below leaves the spectrum axis-reversed (each tensordot
            # puts its result axis first), and the inverse chain reverses it
            # back -- zero explicit transposes.
            inv = np.transpose(inv, tuple(range(grid.ndim - 1, -1, -1)))
            # ... and pre-permuted to the transforms' BLOCK order, so the
            # runtime skips the even/odd interleaves entirely (the only
            # data movement between matmuls is contiguous concats).
            nd_ = grid.ndim
            for j in range(nd_):
                a = nd_ - 1 - j
                plan = plans[a]
                if hasattr(plan, "permutation"):
                    perm = plan.permutation()
                else:
                    perm = dct_mod.split_permutation(
                        grid.shape[a], plan.levels
                    )
                inv = np.take(inv, perm, axis=j)
        solver = DCTPoissonSolver(
            grid=grid,
            inv_eig=jnp.asarray(inv, grid.dtype),
            plans=plans,
            mode=mode,
            precision=precision,
            refine=refine,
            kinds=kinds,
        )
        if self_check:
            # Build-time self-check: shape-specific compiler bugs that
            # silently miscompile the split transform have been seen (rel
            # err O(1)) and move between releases. Solve a manufactured
            # multi-eigenmode RHS once and verify; on failure fall back to
            # the dense (level-0) plans at negligible build cost.
            err = solver._self_check_error(kinds)
            if not (err < 0.05):
                import sys

                if mode == "matmul" and not _force_dense:
                    print(
                        f"[fft_poisson] split-transform self-check FAILED "
                        f"(rel err {err:.3g}) for shape {grid.shape} on "
                        f"backend {jax.default_backend()!r}; falling back "
                        "to dense level-0 transforms",
                        file=sys.stderr,
                    )
                    return DCTPoissonSolver.build(
                        grid, mode, precision, refine,
                        split_levels=0, kinds=kinds,
                        self_check=True, _force_dense=True,
                    )
                raise RuntimeError(
                    f"DCT Poisson self-check failed (rel err {err:.3g}) "
                    f"for shape {grid.shape}, mode {mode!r}, even with "
                    "dense transforms; refusing to produce corrupt physics"
                )
        return solver

    def _self_check_error(self, kinds: tuple[str, ...]) -> float:
        """Relative error of one direct solve on an exact-eigenfunction RHS.

        The test field is a fixed-seed combination of ~8 discrete Laplacian
        eigenmodes (per-axis kind: Neumann cos(pi k (i+1/2)/n), periodic
        cos(2 pi k i/n), mixed-BC DCT-IV / DST-II modes) with wavenumbers
        spread across the spectrum, so every radix-split block carries
        signal. Eigenvalues are computed analytically, making
        solve(sum c lam_m p_m) == sum c p_m exact in exact arithmetic; f32
        transform error is ~1e-4..1e-2, while the miscompile class this
        guards against is O(1).
        """
        shape = self.grid.shape
        spacing = self.grid.spacing
        nd = self.grid.ndim
        rng = np.random.RandomState(0)
        p = np.zeros(shape, np.float64)
        b = np.zeros(shape, np.float64)
        singular = all(k in ("nn", "per") for k in kinds)
        for m in range(8):
            lam = 0.0
            prod = np.ones((1,) * nd, np.float64)
            zero_lam = True
            for a, (n, h) in enumerate(zip(shape, spacing)):
                if m == 0:
                    k = min(1, n - 1)
                elif m == 1:
                    k = n - 1
                else:
                    k = int(rng.randint(0, n))
                i = np.arange(n, dtype=np.float64)
                kind = kinds[a]
                if kind == "per":
                    theta = 2.0 * np.pi * k / n
                    basis = np.cos(2.0 * np.pi * k * i / n)
                elif kind == "nn":
                    theta = np.pi * k / n
                    basis = np.cos(np.pi * k * (i + 0.5) / n)
                elif kind in ("nd", "dn"):
                    theta = np.pi * (2 * k + 1) / (2 * n)
                    j = i if kind == "nd" else (n - 1 - i)
                    basis = np.cos(theta * (j + 0.5))
                else:  # "dd"
                    theta = np.pi * (k + 1) / n
                    basis = np.sin(theta * (i + 0.5))
                lam_a = (2.0 * np.cos(theta) - 2.0) / (h * h)
                if lam_a != 0.0:
                    zero_lam = False
                lam += lam_a
                sh = [1] * nd
                sh[a] = n
                prod = prod * basis.reshape(sh)
            if zero_lam:
                continue  # constant mode is deflated by construction
            c = float(rng.uniform(0.5, 1.0))
            p += c * prod
            b += c * lam * prod
        got = np.asarray(self._direct(jnp.asarray(b, self.grid.dtype)))
        if singular:
            p -= p.mean()
            got = got - got.mean()
        denom = float(np.linalg.norm(p.ravel())) or 1.0
        return float(np.linalg.norm((got - p).ravel())) / denom

    @staticmethod
    def _prec(precision: Optional[str], default: str):
        return {
            "highest": jax.lax.Precision.HIGHEST,
            "high": jax.lax.Precision.HIGH,
            "default": jax.lax.Precision.DEFAULT,
        }[precision or default]

    def _fwd(self, x: Array, prec) -> Array:
        """Forward transform chain (matmul mode): after it the axes read
        (k_{nd-1}, ..., k_0), each in the split transforms' block order
        (inv_eig is stored to match)."""
        nd = self.grid.ndim
        for a in range(nd):
            plan = self.plans[a]
            if hasattr(plan, "apply_fwd"):
                x = plan.apply_fwd(x, a, prec)
            else:
                x = dct_mod.split_dct_apply(
                    plan, x, a, prec, block_order=True
                )
        return x

    def _inv(self, x: Array, prec) -> Array:
        """Inverse chain: unwinds the reversal, natural axis order out."""
        nd = self.grid.ndim
        for a in range(nd - 1, -1, -1):
            plan = self.plans[a]
            if hasattr(plan, "apply_fwd"):
                x = plan.apply_inv(x, nd - 1 - a, prec)
            else:
                x = dct_mod.split_idct_apply(
                    plan, x, nd - 1 - a, prec, block_order=True
                )
        return x

    def _direct(self, b: Array, precision: Optional[str] = None) -> Array:
        """One application of the diagonalized inverse Laplacian."""
        nd = self.grid.ndim
        prec = self._prec(precision, self.precision)
        if self.mode == "matmul":
            return self._inv(self._fwd(b, prec) * self.inv_eig, prec)
        x = b
        for a in range(nd):
            x = dct_mod.dct2(x, axis=a)
        x = x * self.inv_eig
        for a in range(nd):
            x = dct_mod.idct2(x, axis=a)
        return x

    def solve(self, b: Array, op: Optional[PoissonOp] = None) -> Array:
        """Solve ``lap p = b`` (mean-zero branch), mean(p) = 0.

        With ``refine > 0`` (requires ``op``), applies mixed-precision
        iterative refinement: ``p += direct(b - A p)`` with the residual
        evaluated by the exact f32 stencil operator.
        """
        p = self._direct(b)
        if self.refine and op is not None:
            for _ in range(self.refine):
                with jax.named_scope("refine_residual"):
                    r = (b - apply_A(op, p)) * op.fluid
                p = p + self._direct(r, self.refine_precision)
        return p


def solve_with_residual(
    solver: DCTPoissonSolver, op: PoissonOp, b: Array,
    diag_residual: bool = True,
) -> tuple[Array, Array, Array]:
    """Solve and report (p, iters=1, relative residual) for diagnostics,
    using the same norm as the iterative solvers (ops/poisson.py).

    On the singular (pure-Neumann/periodic) problem the RHS is deflated
    to its mean-zero part first; ``inv_eig`` is zero at the constant mode
    anyway, but the refinement residual is only meaningful against the
    solvable system, and the residual is reported against it too. With
    any Dirichlet (outflow) axis the operator is nonsingular: no mode is
    pinned and no deflation happens anywhere."""
    bd = b - jnp.mean(b) if solver.singular else b
    p = solver.solve(bd, op)
    if not diag_residual:
        # reporting skipped (PoissonConfig.diag_residual=False): sentinel
        return p, jnp.int32(1), jnp.asarray(-1.0, b.dtype)
    bnorm = jnp.sqrt(jnp.sum(b * b))
    tiny = jnp.asarray(np.finfo(np.float32).tiny, b.dtype)
    res = residual_norm(op, p, bd) / jnp.maximum(bnorm, tiny)
    return p, jnp.int32(1), res


@dataclasses.dataclass(eq=False)
class DCTPCGSolver:
    """Spectrally-preconditioned CG for obstacle topologies (method
    ``dctcg``).

    The direct DCT solver is exact for the UNMASKED operator -- walls,
    inflow, outflow faces all diagonalize (axis_kinds_from_bcs). An interior
    obstacle only perturbs the operator through its CUT LINKS (fluid-solid
    face pairs): with one Woodbury column ``sqrt(w_a) (e_i - e_s)`` per cut
    link, the embedded operator ``B = U + W W^T`` reproduces the masked
    fluid rows EXACTLY (fluid diag gains +w per cut link, the fluid-solid
    coupling cancels), while the solid block becomes a decoupled interior
    Neumann problem whose values the fluid never sees. The capacitance
    matrix ``C = I + W^T U^{-1} W`` (K x K, K ~ obstacle perimeter) is
    inverted once at build; each preconditioner application is then

        z = U^{-1} r  -  U^{-1} W C^{-1} W^T U^{-1} r

    i.e. two transform solves + a K-vector gather/scatter + one K x K
    matvec -- an (approximately) EXACT masked inverse. The iteration
    collapses to the few sweeps needed to mop up the transforms' rounding
    noise, independent of grid size (the classic capacitance-matrix
    method, Proskurowski & Widlund 1976, recast onto dense matmuls).

    The f32 stencil ``matvec`` inside the iteration keeps residuals exact,
    and the flexible (Polak-Ribiere) beta absorbs the preconditioner's
    relative noise. Same stopping semantics as every solver in
    ops/poisson.py (relative L2 of ``b - A p``).
    """

    dct: DCTPoissonSolver
    # "highest" (full f32): with the capacitance correction the
    # preconditioner is exact up to transform noise, so each sweep's
    # precision sets how many residual decades it buys. On an H100 the
    # TF32 ("default"/"high") application needed 2-3 sweeps/step at
    # 2048x1024 and left max|div u| at 3e-3; full f32 needs 1 sweep and is
    # no slower per step (PERF.md).
    precond_precision: str = "highest"
    # Capacitance correction (None when there is no obstacle, or when the
    # unmasked operator is singular -- Woodbury needs U^{-1} proper; the
    # plain spectral preconditioner still applies there). W is stored as a
    # DENSE (K, *box) tensor over the obstacle's bounding box: W^T z and
    # W h then run as small dense contractions instead of 2K-point
    # gather/scatters.
    cap_origin: Optional[tuple[int, ...]] = None   # box corner (static)
    cap_wbox: Optional[Array] = None     # (K, *box_shape) column images
    cap_cinv: Optional[Array] = None     # (K, K) inverse capacitance matrix
    # 2D spectral-domain correction: the Woodbury term is evaluated INSIDE
    # the transform chain, so one application costs one forward+inverse
    # chain plus two thin point-matmuls instead of two full spectral
    # solves. The link-point rows/columns of the per-axis transform
    # matrices are precomputed in the plans' block order:
    #   z-sample:  z[p] = sum_{k1,k0} Vy[y_p,k1] Vx[x_p,k0] that[k1,k0]
    #   source:    shat[k1,k0] = sum_p c_p Fy[k1,y_p] Fx[k0,x_p]
    cap_vx: Optional[Array] = None       # (2K, n0_spec) inverse rows at x_p
    cap_vy: Optional[Array] = None       # (2K, n1_spec) inverse rows at y_p
    cap_fx: Optional[Array] = None       # (n0_spec, 2K) forward cols at x_p
    cap_fy: Optional[Array] = None       # (n1_spec, 2K) forward cols at y_p
    cap_va: Optional[Array] = None       # (K,) +entry values (sqrt(w)/pin)
    cap_vb: Optional[Array] = None       # (K,) -entry values
    # flat link endpoints kept for introspection/tests
    cap_idx_a: Optional[np.ndarray] = None
    cap_idx_b: Optional[np.ndarray] = None

    @staticmethod
    def build(
        grid: GridSpec,
        bcs: BCTable,
        solid: Optional[np.ndarray] = None,
        precond_precision: str = "highest",
        capacitance: bool = True,
        spectral: bool = True,
    ) -> "DCTPCGSolver":
        kinds = axis_kinds_from_bcs(grid, bcs)
        dct = DCTPoissonSolver.build(grid, refine=0, kinds=kinds)
        have_solid = solid is not None and bool(np.any(solid))
        cap = capacitance and have_solid and not dct.singular
        s = DCTPCGSolver(dct=dct, precond_precision=precond_precision)
        if cap:
            s._build_capacitance(grid, np.asarray(solid, bool), kinds)
            if spectral and grid.ndim == 2 and dct.mode == "matmul":
                s._build_spectral_correction(grid)
        return s

    def _axis_matrices(self, a: int, n: int, dtype):
        """The axis-``a`` transform as explicit matrices by running the
        plan machinery over an identity: F (n_spec, n_real) forward in the
        plan's block order, V (n_real, n_spec) inverse."""
        plan = self.dct.plans[a]
        eye = jnp.eye(n, dtype=dtype)
        hi = jax.lax.Precision.HIGHEST
        if hasattr(plan, "apply_fwd"):
            F = plan.apply_fwd(eye, 0, hi)
            V = plan.apply_inv(eye, 0, hi)
        else:
            F = dct_mod.split_dct_apply(plan, eye, 0, hi, block_order=True)
            V = dct_mod.split_idct_apply(plan, eye, 0, hi, block_order=True)
        return np.asarray(F), np.asarray(V)

    def _build_spectral_correction(self, grid: GridSpec) -> None:
        pts_a = np.unravel_index(self.cap_idx_a, grid.shape)
        pts_b = np.unravel_index(self.cap_idx_b, grid.shape)
        xs = np.concatenate([pts_a[0], pts_b[0]])
        ys = np.concatenate([pts_a[1], pts_b[1]])
        F0, V0 = self._axis_matrices(0, grid.shape[0], grid.dtype)
        F1, V1 = self._axis_matrices(1, grid.shape[1], grid.dtype)
        self.cap_vx = jnp.asarray(V0[xs, :], grid.dtype)
        self.cap_vy = jnp.asarray(V1[ys, :], grid.dtype)
        self.cap_fx = jnp.asarray(F0[:, xs], grid.dtype)
        self.cap_fy = jnp.asarray(F1[:, ys], grid.dtype)
        # the runtime never touches the box images on this path
        self.cap_wbox = None
        self.cap_origin = None

    def _build_capacitance(
        self, grid: GridSpec, solid: np.ndarray, kinds: tuple[str, ...]
    ) -> None:
        fluid = np.logical_not(solid)
        nd = grid.ndim
        idx_a, idx_b, val = [], [], []
        flat = np.arange(int(np.prod(grid.shape))).reshape(grid.shape)
        for a in range(nd):
            w = 1.0 / (grid.spacing[a] ** 2)
            if kinds[a] == "per":
                nb_flat = np.roll(flat, -1, axis=a)
                cut = fluid & np.roll(solid, -1, axis=a)
                cut_r = solid & np.roll(fluid, -1, axis=a)
                pairs = [(flat[cut], nb_flat[cut]),
                         (nb_flat[cut_r], flat[cut_r])]
            else:
                lo = [slice(None)] * nd
                hi = [slice(None)] * nd
                lo[a] = slice(0, -1)
                hi[a] = slice(1, None)
                lo, hi = tuple(lo), tuple(hi)
                cut = fluid[lo] & solid[hi]      # fluid i | solid i+1
                cut_r = solid[lo] & fluid[hi]    # solid i | fluid i+1
                pairs = [(flat[lo][cut], flat[hi][cut]),
                         (flat[hi][cut_r], flat[lo][cut_r])]
            for fi, si in pairs:
                idx_a.append(fi)
                idx_b.append(si)
                val.append(np.full(fi.shape, np.sqrt(w)))
        idx_a = np.concatenate(idx_a)
        idx_b = np.concatenate(idx_b)
        val_a = np.concatenate(val)
        val_b = -val_a
        # One pin column per connected solid component: the embedded solid
        # block is an interior Neumann problem (nullspace = its constants);
        # sqrt(alpha) e_pin shifts that mode so C stays invertible.
        from scipy import ndimage

        labels, ncomp = ndimage.label(solid)
        alpha = max(1.0 / (h * h) for h in grid.spacing)
        for c in range(1, ncomp + 1):
            pin = int(flat[labels == c].ravel()[0])
            idx_a = np.append(idx_a, pin)
            idx_b = np.append(idx_b, pin)  # unused (val_b = 0)
            val_a = np.append(val_a, np.sqrt(alpha))
            val_b = np.append(val_b, 0.0)
        K = idx_a.shape[0]

        # Dense W over the link bounding box. For a compact obstacle the
        # box is a few obstacle diameters (K * |box| floats, tens of MB);
        # an obstacle wrapping a periodic seam degrades the box to the full
        # axis extent, which is still correct, just larger.
        pts = np.stack(
            np.unravel_index(np.concatenate([idx_a, idx_b]), grid.shape),
            axis=1,
        )
        lo = pts.min(axis=0)
        hi = pts.max(axis=0) + 1
        box_shape = tuple(int(h - l) for l, h in zip(lo, hi))
        wbox = np.zeros((K,) + box_shape, np.float64)
        aa = np.unravel_index(idx_a, grid.shape)
        bb = np.unravel_index(idx_b, grid.shape)
        ks = np.arange(K)
        wbox[(ks,) + tuple(a - l for a, l in zip(aa, lo))] += val_a
        np.add.at(
            wbox, (ks,) + tuple(b - l for b, l in zip(bb, lo)), val_b
        )

        # Capacitance matrix C = I + W^T U^{-1} W via K batched spectral
        # solves at build time ("highest" precision -- built once, used
        # every step). Chunked so the RHS batch stays ~tens of MB. The big
        # arrays (the (K, |box|) column images and the grid-shaped
        # inverse-eigenvalue tensor) are jit ARGUMENTS, not closure
        # captures: baked in, they would put >1 GB of constants into the
        # program at sphere-at-512x256x256 scale.
        wbox_j = jnp.asarray(wbox, grid.dtype)
        origin = tuple(int(x) for x in lo)
        n_cells = int(np.prod(grid.shape))
        chunk = max(1, min(16, (64 * 1024 * 1024) // (4 * n_cells)))
        import dataclasses as _dc

        @jax.jit
        def wtuw_chunk(wb, wflat_t, inv_eig):
            dct = _dc.replace(self.dct, inv_eig=inv_eig)

            def embed(w):
                return jax.lax.dynamic_update_slice(
                    jnp.zeros(grid.shape, grid.dtype), w, origin
                )

            cols = jax.vmap(embed)(wb)
            ys = jax.vmap(lambda c: dct._direct(c, "highest"))(cols)
            ybox = jax.lax.dynamic_slice(
                ys, (0,) + origin, (wb.shape[0],) + box_shape
            )
            return jnp.tensordot(
                ybox.reshape(wb.shape[0], -1),
                wflat_t,
                axes=1,
                precision=jax.lax.Precision.HIGHEST,
            )   # (chunk, K)

        wflat_t = wbox_j.reshape(K, -1).T
        blocks = []
        for i0 in range(0, K, chunk):
            blocks.append(np.asarray(wtuw_chunk(
                wbox_j[i0:i0 + chunk], wflat_t, self.dct.inv_eig
            )))
        wtuw = np.concatenate(blocks, axis=0)
        C = np.eye(K, dtype=np.float64) + wtuw.astype(np.float64)
        cinv = np.linalg.inv(C)
        self.cap_origin = origin
        self.cap_wbox = wbox_j
        self.cap_cinv = jnp.asarray(cinv, grid.dtype)
        self.cap_va = jnp.asarray(val_a, grid.dtype)
        self.cap_vb = jnp.asarray(val_b, grid.dtype)
        self.cap_idx_a = idx_a
        self.cap_idx_b = idx_b

    def halo_consts(self):
        """Build-time arrays for the explicit-halo (shard_map) dctcg path
        (round 4, VERDICT r3 item 2 'real target'): 2D matmul mode only.

        The distributed preconditioner runs the transforms as LOCAL dense
        matmuls around ONE all-to-all pencil transpose per direction: the
        grid is row-sharded ('sx' slabs), so the axis-1 transform is
        local; the axis-0 transform happens after transposing to
        k1-sharded pencils. ``inv_nat`` is the spectral multiplier in
        NATURAL block-order (k0, k1) layout -- the chain path's reversed
        tensor transposed -- sharded over k1; the Woodbury sample/source
        matrices are the per-axis rows/columns the 2D spectral-domain
        correction already precomputed, so the capacitance term costs one
        (k0, 2K) psum. The dense per-axis matrices cost ~2x the radix-
        split chain's MACs -- the halo path trades that for explicit,
        schedulable communication.
        """
        import numpy as _np

        grid = self.dct.grid
        if grid.ndim == 3:
            # 3D slabs (round 5, VERDICT r4 item 4): per-axis dense
            # matrices; axes 1/2 transform locally, axis 0 after ONE
            # all-to-all pencil transpose per direction (k1-sharded
            # pencils). The capacitance branch keeps the unsharded
            # generic structure -- two spectral solves around the dense-
            # box W contraction -- with the box rows gathered/scattered
            # across shards by a one-hot row map + psum (box ~ obstacle
            # bounding box, a psum of |box| floats per application).
            F0, V0 = self._axis_matrices(0, grid.shape[0], grid.dtype)
            F1, V1 = self._axis_matrices(1, grid.shape[1], grid.dtype)
            F2, V2 = self._axis_matrices(2, grid.shape[2], grid.dtype)
            inv_nat = jnp.asarray(
                _np.transpose(_np.asarray(self.dct.inv_eig),
                              (2, 1, 0)).copy(), grid.dtype
            )
            hc = dict(
                F0=jnp.asarray(F0, grid.dtype),
                V0=jnp.asarray(V0, grid.dtype),
                F1=jnp.asarray(F1, grid.dtype),
                V1=jnp.asarray(V1, grid.dtype),
                F2=jnp.asarray(F2, grid.dtype),
                V2=jnp.asarray(V2, grid.dtype),
                inv_nat=inv_nat,
            )
            if self.cap_cinv is not None:
                K = self.cap_cinv.shape[0]
                hc.update(
                    wflat=self.cap_wbox.reshape(K, -1),
                    cinv=self.cap_cinv,
                )
            return hc
        if grid.ndim != 2 or self.dct.mode != "matmul":
            return None
        if self.cap_cinv is not None and self.cap_vx is None:
            return None   # capacitance without the 2D spectral arrays
        F0, V0 = self._axis_matrices(0, grid.shape[0], grid.dtype)
        F1, V1 = self._axis_matrices(1, grid.shape[1], grid.dtype)
        inv_nat = jnp.asarray(
            _np.asarray(self.dct.inv_eig).T.copy(), grid.dtype
        )
        hc = dict(
            F0=jnp.asarray(F0, grid.dtype), V0=jnp.asarray(V0, grid.dtype),
            F1=jnp.asarray(F1, grid.dtype), V1=jnp.asarray(V1, grid.dtype),
            inv_nat=inv_nat,
        )
        if self.cap_cinv is not None:
            hc.update(
                vx=self.cap_vx, vy=self.cap_vy,
                fx=self.cap_fx, fy=self.cap_fy,
                cinv=self.cap_cinv, va=self.cap_va, vb=self.cap_vb,
            )
        return hc

    def _precond_sharded(self, hc, r: Array, fluid: Array, axis: str,
                         prec) -> Array:
        """Distributed (capacitance-corrected) unmasked inverse, executed
        INSIDE shard_map over ``axis`` ('sx' row slabs). hc leaves arrive
        per-shard: inv_nat/vy sliced over k1, fy over its k1 rows; the
        rest replicated."""
        F0, V0, F1, V1 = hc["F0"], hc["V0"], hc["F1"], hc["V1"]
        # local axis-1 forward: (b, n1) @ F1^T -> (b, k1)
        t1 = jnp.matmul(r, F1.T, precision=prec)
        # pencil transpose: row slabs -> k1 slabs (full rows)
        t1 = jax.lax.all_to_all(t1, axis, split_axis=1, concat_axis=0,
                                tiled=True)            # (n0, k1/N)
        that = jnp.matmul(F0, t1, precision=prec) * hc["inv_nat"]
        if "cinv" in hc:
            vx, vy = hc["vx"], hc["vy"]                # (2K, k0), (2K, k1/N)
            # zp[p] = sum_{k0,k1} vx[p,k0] vy[p,k1] that[k0,k1]
            S = jnp.matmul(that, vy.T, precision=prec)  # (k0, 2K) local k1
            S = jax.lax.psum(S, axis)
            zp = jnp.sum(vx * S.T, axis=1)              # (2K,)
            K = hc["va"].shape[0]
            g = hc["va"] * zp[:K] + hc["vb"] * zp[K:]
            h = hc["cinv"] @ g
            c = jnp.concatenate([hc["va"] * h, hc["vb"] * h])
            # shat[k0, k1] = sum_p fx[k0,p] c_p fy[k1,p] (fy rows local)
            shat = jnp.matmul(
                hc["fx"], (hc["fy"] * c[None, :]).T, precision=prec
            )                                           # (k0, k1/N)
            that = that - hc["inv_nat"] * shat
        z = jnp.matmul(V0, that, precision=prec)        # (n0, k1/N)
        z = jax.lax.all_to_all(z, axis, split_axis=0, concat_axis=1,
                               tiled=True)              # (b, k1)
        z = jnp.matmul(z, V1.T, precision=prec)         # (b, n1)
        return z * fluid

    def _direct_sharded_3d(self, hc, r: Array, axis: str, prec) -> Array:
        """Distributed 3D unmasked spectral inverse on 'sx' row slabs:
        axes 1/2 local dense transforms, axis 0 around one all-to-all
        pencil transpose per direction (k1-sharded)."""
        F0, V0 = hc["F0"], hc["V0"]
        F1, V1 = hc["F1"], hc["V1"]
        F2, V2 = hc["F2"], hc["V2"]
        t = jnp.einsum("bmn,kn->bmk", r, F2, precision=prec)
        t = jnp.einsum("bmk,jm->bjk", t, F1, precision=prec)
        t = jax.lax.all_to_all(t, axis, split_axis=1, concat_axis=0,
                               tiled=True)            # (n0, k1/N, k2)
        that = jnp.einsum("bjk,ib->ijk", t, F0,
                          precision=prec) * hc["inv_nat"]
        z = jnp.einsum("ijk,bi->bjk", that, V0, precision=prec)
        z = jax.lax.all_to_all(z, axis, split_axis=0, concat_axis=1,
                               tiled=True)            # (b, k1, k2)
        z = jnp.einsum("bjk,mj->bmk", z, V1, precision=prec)
        return jnp.einsum("bmk,nk->bmn", z, V2, precision=prec)

    def _precond_sharded_3d(self, hc, r: Array, fluid: Array, axis: str,
                            prec) -> Array:
        """Distributed 3D (capacitance-corrected) unmasked inverse,
        executed INSIDE shard_map over ``axis``: the generic two-solve
        structure of :meth:`_precond_apply`'s 3D branch, with the dense
        W box gathered from / scattered to the owning shards via a
        one-hot row map (box rows -> local rows is shard-dependent but
        static-shaped) and one psum of the (bx, by, bz) box."""
        z = self._direct_sharded_3d(hc, r, axis, prec)
        if "cinv" in hc:
            o0, o1, o2 = self.cap_origin
            bx, by, bz = self.cap_wbox.shape[1:]
            b = z.shape[0]
            gi = jax.lax.axis_index(axis) * b + jnp.arange(b)
            M = (gi[:, None] - o0 == jnp.arange(bx)[None, :]).astype(
                z.dtype
            )                                         # (b, bx) ownership
            zc = jax.lax.dynamic_slice(z, (0, o1, o2), (b, by, bz))
            zbox = jnp.einsum("br,bjk->rjk", M, zc, precision=prec)
            zbox = jax.lax.psum(zbox, axis)
            g = jnp.matmul(hc["wflat"], zbox.reshape(-1), precision=prec)
            h = jnp.matmul(hc["cinv"], g, precision=prec)
            src_box = jnp.matmul(h, hc["wflat"], precision=prec).reshape(
                bx, by, bz
            )
            src_rows = jnp.einsum("br,rjk->bjk", M, src_box,
                                  precision=prec)
            src = jax.lax.dynamic_update_slice(
                jnp.zeros_like(z), src_rows, (0, o1, o2)
            )
            z = z - self._direct_sharded_3d(hc, src, axis, prec)
        return z * fluid

    def solve_halo(self, hc, b: Array, p0: Array, tol, max_iters: int,
                   op: PoissonOp, ctx, axis: str):
        """Explicit-comm dctcg solve body (inside shard_map): the
        capacitance branch runs the same Richardson recurrence as
        :meth:`_solve_richardson` with ctx-aware residuals/norms; the
        singular branch runs ctx-aware flexible_pcg around the plain
        distributed spectral preconditioner. Convergence semantics are
        the single-device ones by construction (shared stopping rule,
        psum'd reductions)."""
        from .poisson import deflate, flexible_pcg

        fluid = op.fluid
        prec = DCTPoissonSolver._prec(None, self.precond_precision)
        if self.dct.grid.ndim == 3:
            def pre(r):
                return self._precond_sharded_3d(hc, r, fluid, axis, prec)
        else:
            def pre(r):
                return self._precond_sharded(hc, r, fluid, axis, prec)
        if self.cap_cinv is None:
            def precond(r):
                z = -pre(r)
                return deflate(op, z, ctx) if op.singular else z

            return flexible_pcg(op, b, p0, tol, max_iters, precond,
                                ctx=ctx)

        dt = b.dtype
        b = b * fluid
        p0 = p0 * fluid
        bsq = ctx.psum(jnp.sum(b * b))
        bnorm = jnp.sqrt(bsq)
        tiny = jnp.asarray(np.finfo(np.float32).tiny, dt)
        inv_bnorm = 1.0 / jnp.maximum(bnorm, tiny)
        tol = jnp.asarray(tol, dt)

        def resid(p):
            return (b - apply_A(op, p, ctx)) * fluid

        def norm(r):
            return jnp.sqrt(ctx.psum(jnp.sum(r * r))) * inv_bnorm

        r0 = resid(p0)
        res0 = norm(r0)
        p1 = p0 + pre(r0)
        r1 = resid(p1)
        res1 = norm(r1)

        def cond(carry):
            p, r, k, res, prev = carry
            improving = res < 0.9 * prev
            return jnp.logical_and(
                jnp.logical_and(k < max_iters, res > tol), improving
            )

        def body(carry):
            p, r, k, res, _ = carry
            p = p + pre(r)
            r = resid(p)
            return p, r, k + 1, norm(r), res

        p, r, iters, res, _ = jax.lax.while_loop(
            cond, body, (p1, r1, jnp.int32(1), res1, res0)
        )
        return p, iters, res

    def _precond_apply(
        self, r: Array, fluid: Array, precision: Optional[str] = None
    ) -> Array:
        """One application of the (capacitance-corrected) unmasked inverse."""
        prec_name = precision or self.precond_precision
        if self.cap_cinv is None:
            return self.dct._direct(r, prec_name) * fluid
        if self.cap_vx is not None:
            # 2D spectral-domain path: sample + re-inject the Woodbury
            # term inside the transform chain -- one forward + one inverse
            # chain total, plus two thin (2K x n) point-matmuls, instead
            # of two full spectral solves.
            dct = self.dct
            prec = dct._prec(prec_name, dct.precision)
            that = dct._fwd(r, prec) * dct.inv_eig        # (k1, k0)
            S = jnp.matmul(self.cap_vy, that, precision=prec)   # (2K, k0)
            zp = jnp.sum(S * self.cap_vx, axis=1)               # (2K,)
            K = self.cap_va.shape[0]
            g = self.cap_va * zp[:K] + self.cap_vb * zp[K:]
            h = self.cap_cinv @ g
            c = jnp.concatenate([self.cap_va * h, self.cap_vb * h])
            shat = jnp.matmul(
                self.cap_fy * c[None, :], self.cap_fx.T, precision=prec
            )                                                    # (k1, k0)
            z = dct._inv(that - dct.inv_eig * shat, prec)
            return z * fluid
        # generic (3D) path: two full spectral solves around the dense-box
        # W contractions
        z = self.dct._direct(r, prec_name)
        K = self.cap_wbox.shape[0]
        box_shape = self.cap_wbox.shape[1:]
        zbox = jax.lax.dynamic_slice(z, self.cap_origin, box_shape)
        wflat = self.cap_wbox.reshape(K, -1)
        g = wflat @ zbox.reshape(-1)          # W^T U^{-1} r   (K,)
        h = self.cap_cinv @ g                  # C^{-1} g       (K,)
        src_box = (h @ wflat).reshape(box_shape)   # W h, dense box
        src = jax.lax.dynamic_update_slice(
            jnp.zeros_like(z), src_box, self.cap_origin
        )
        z = z - self.dct._direct(src, prec_name)
        return z * fluid

    def solve(
        self, b: Array, p0: Array, tol, max_iters: int, op: PoissonOp
    ) -> tuple[Array, Array, Array]:
        from .poisson import deflate, flexible_pcg

        fluid = op.fluid
        singular = op.singular

        if self.cap_cinv is not None:
            return self._solve_richardson(b, p0, tol, max_iters, op)

        def precond(r):
            # _direct applies A_unmasked^{-1}; the negated system wants
            # (-A)^{-1} r = -(A^{-1} r). Mask to the fluid subspace so
            # M = P A^{-1} P stays symmetric PSD there.
            z = -self._precond_apply(r, fluid)
            return deflate(op, z) if singular else z

        return flexible_pcg(op, b, p0, tol, max_iters, precond)

    def _solve_richardson(
        self, b: Array, p0: Array, tol, max_iters: int, op: PoissonOp
    ) -> tuple[Array, Array, Array]:
        """Preconditioned Richardson (iterative refinement): p += M(b - Ap).

        With the capacitance correction, M is the masked inverse up to
        transform noise (contraction ~1e-3..1e-4 per sweep at "high"
        precision), so Krylov acceleration buys nothing -- but CG costs one
        EXTRA preconditioner application for its initial z0 plus 3 extra
        reductions per iteration, and each application is two transform
        chains of matmuls. Richardson needs exactly `iters` applications.
        Same stopping semantics as every solver here (relative L2 of
        ``b - A p``, iteration cap, mg-style stagnation bail at the f32
        floor). The FIRST sweep is unrolled OUTSIDE the while_loop, so a
        warm-started step that converges in one sweep never enters the
        loop.
        """
        fluid = op.fluid
        dt = b.dtype
        b = b * fluid
        p0 = p0 * fluid
        bnorm = jnp.sqrt(jnp.sum(b * b))
        tiny = jnp.asarray(np.finfo(np.float32).tiny, dt)
        inv_bnorm = 1.0 / jnp.maximum(bnorm, tiny)
        tol = jnp.asarray(tol, dt)

        def resid(p):
            return (b - apply_A(op, p)) * fluid

        def norm(r):
            return jnp.sqrt(jnp.sum(r * r)) * inv_bnorm

        # unrolled first sweep (always taken; a warm start that already
        # satisfies tol just gets one extra refinement -- harmless, and the
        # common path never enters the while_loop at all).
        r0 = resid(p0)
        res0 = norm(r0)
        p1 = p0 + self._precond_apply(r0, fluid)
        r1 = resid(p1)
        res1 = norm(r1)

        def cond(carry):
            p, r, k, res, prev = carry
            improving = res < 0.9 * prev
            return jnp.logical_and(
                jnp.logical_and(k < max_iters, res > tol), improving
            )

        def body(carry):
            p, r, k, res, _ = carry
            p = p + self._precond_apply(r, fluid)
            r = resid(p)
            return p, r, k + 1, norm(r), res

        p, r, iters, res, _ = jax.lax.while_loop(
            cond, body, (p1, r1, jnp.int32(1), res1, res0)
        )
        return p, iters, res
