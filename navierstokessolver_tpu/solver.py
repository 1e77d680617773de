"""Chorin projection time stepper: predictor -> Poisson -> corrector.

Capability parity: the reference's time-step driver (SURVEY.md SS3.1 call
stack): explicit advection-diffusion predictor, pressure Poisson solve,
velocity correction, BC re-application, periodic output. The whole step
is pure-functional jnp/lax code that XLA fuses per device; ``run_scan`` wraps N steps in one
jit-compiled ``lax.scan`` with zero host round-trips (BASELINE.json north
star), and the pressure from step k warm-starts the Poisson solve at k+1.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import bcs as bcs_mod
from .bcs import BCTable
from .grid import GridSpec, State, zero_state
from .ops import poisson as poisson_mod
from .ops import stencils
from .ops.poisson import PoissonConfig, PoissonOp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static physical/numerical parameters of a run."""

    dt: float
    nu: float
    rho: float = 1.0
    upwind_gamma: float = 0.0
    poisson: PoissonConfig = dataclasses.field(default_factory=PoissonConfig)
    # Time integrator: "euler" (reference-style explicit first order) or
    # "rk2" (midpoint rule, one projection per stage, second order in time).
    # SURVEY.md SS0.3 parks the reference's integrator order as unknown.
    integrator: str = "euler"
    # CFL-adaptive stepping: when set, each step uses
    # dt_k = min(dt, cfl * min_a(h_a / max|u_a|)) computed on device
    # (`dt` then acts as the cap / diffusive limit). None = fixed dt.
    cfl: Optional[float] = None


class StepDiagnostics(NamedTuple):
    poisson_iters: Array   # iterations the pressure solve took
    poisson_res: Array     # final relative residual
    max_div: Array         # max |div u| after projection
    max_cfl: Array         # advective CFL of the accepted step
    dt: Array              # dt actually used (varies under CFL-adaptive mode)


@dataclasses.dataclass(eq=False)  # identity hash: usable as a jit static
class Simulation:
    """Bundles the static pieces of a problem; exposes pure step functions.

    All members are either Python statics or device arrays captured as jit
    constants, so ``make_step_fn()`` returns a closure that jit/scan/shard
    cleanly.
    """

    grid: GridSpec
    bcs: BCTable
    params: SimParams
    op: PoissonOp
    face_masks: Optional[tuple[Array, ...]]
    corr_masks: Optional[tuple[Array, ...]]
    forcing: Optional[tuple[Array, ...]] = None
    # Domain-decomposition shardings (a State-shaped pytree of NamedSharding).
    # Applied as with_sharding_constraint at step entry/exit: GSPMD then lays
    # out every stencil as halo exchanges over the mesh (supports uneven
    # staggered dims, which device_put/out_shardings reject).
    shardings: Optional[State] = None
    # Direct spectral solver (set when params.poisson.method == "fft").
    dct_solver: Optional[object] = None
    # Geometric multigrid solver (set when params.poisson.method == "mg").
    mg_solver: Optional[object] = None
    # Spectrally-preconditioned CG (set when method == "dctcg"): the exact
    # unmasked DCT inverse preconditions CG on the obstacle-masked operator.
    dctcg_solver: Optional[object] = None
    # Explicit halo-exchange pressure solver (parallel/halo.py): set by
    # parallel.sharded_simulation(..., poisson_comm="halo") for
    # jacobi/gs/sor/cg runs; the Poisson while_loop then runs as ONE
    # shard_map'd program with hand-written ppermute halos + psum
    # reductions instead of GSPMD-inserted collectives.
    halo_solver: Optional[object] = None
    # Optional transported scalar + Boussinesq coupling (scalar.py).
    scalar: Optional[object] = None
    # Solid-cell mask (bool, cell-centered) for the SCALAR's immersed-body
    # treatment -- set when both a scalar and an obstacle are configured
    # (scalar.body_bc selects isothermal/adiabatic; scalar.py module doc).
    scalar_solid: Optional[Array] = None
    # Optional Smagorinsky LES closure (les.py): adds the subgrid stress
    # divergence to the predictor each stage.
    les: Optional[object] = None
    # Optional sharp-interface immersed boundary (ibm.py): direct forcing
    # on the first fluid face ring before each projection. Layers on top
    # of the staircase masks (which stay as the pressure treatment).
    ibm: Optional[object] = None
    # Reverse-mode differentiable pressure solve (adjoint.py): wrap
    # _solve_pressure in an implicit-function-theorem custom VJP so
    # jax.grad flows through the projection without unrolling the
    # iterative solver's while_loop (which is not reverse-differentiable).
    # Set via adjoint.differentiable(sim).
    diff_solve: bool = False

    @staticmethod
    def build(
        grid: GridSpec,
        bcs: BCTable,
        params: SimParams,
        solid: Optional[np.ndarray] = None,
        forcing: Optional[tuple[Array, ...]] = None,
        scalar=None,
        les=None,
        sdf=None,
        surface_velocity=None,
        sharp_pressure: bool = False,
    ) -> "Simulation":
        """``sdf``: optional signed-distance function of the obstacle
        surface (negative inside). When given (and ``solid`` is None) the
        staircase cell mask derives from it AND the velocity boundary
        treatment upgrades to sharp-interface direct forcing (ibm.py).
        ``surface_velocity(*coords) -> nd components``: optional body
        surface velocity for moving boundaries (e.g. a rotating
        cylinder); requires ``sdf``. ``sharp_pressure`` (requires sdf):
        cut-cell apertured Poisson/divergence/correction (cutcell.py) --
        the pressure side of the sharp-interface story; iterative
        solvers only (jacobi/gs/sor/cg/mg/mgcg)."""
        bcs_mod.validate_bcs(grid, bcs)
        ibm_op = None
        cut = None
        if sharp_pressure:
            if sdf is None:
                raise ValueError("sharp_pressure requires an sdf")
            if params.poisson.method in ("fft", "dctcg"):
                raise ValueError(
                    "sharp_pressure needs an iterative/mg Poisson method "
                    f"(the {params.poisson.method!r} spectral machinery "
                    "assumes binary masks)"
                )
            from . import cutcell

            cut = cutcell.cut_geometry(grid, sdf)
            solid = np.asarray(cut[2])
        if sdf is not None:
            from . import ibm as ibm_mod

            if solid is None:
                solid = ibm_mod.solid_from_sdf(grid, sdf)
        scalar_solid = None
        if scalar is not None:
            scalar.validate(grid)
            per = bcs_mod.periodic_axes(grid, bcs)
            if scalar.buoyancy and any(
                b != 0.0 and per[a] for a, b in enumerate(scalar.buoyancy)
            ):
                raise ValueError(
                    "Boussinesq buoyancy along a periodic axis is not "
                    "supported (the wrap predictor expects n-face forcing)"
                )
            if solid is not None and np.asarray(solid).any():
                if scalar.body_bc is None:
                    raise ValueError(
                        "scalar transport with an obstacle needs "
                        "scalar.body_bc (ScalarBC.dirichlet(v) for an "
                        "isothermal body, ScalarBC.adiabatic() for an "
                        "insulated one)"
                    )
                scalar_solid = jnp.asarray(np.asarray(solid), bool)
        dct_solver = None
        if params.poisson.method == "fft":
            from .ops import fft_poisson

            if not fft_poisson.is_applicable(grid, bcs, solid):
                raise ValueError(
                    "poisson method 'fft' needs an obstacle-free domain "
                    "(walls/inflow/outflow/periodic faces all diagonalize, "
                    "but an interior obstacle mask does not); use an "
                    "iterative method or 'dctcg' for this case"
                )
            dct_solver = fft_poisson.DCTPoissonSolver.build(
                grid, kinds=fft_poisson.axis_kinds_from_bcs(grid, bcs)
            )
        dctcg_solver = None
        if params.poisson.method == "dctcg":
            from .ops import fft_poisson

            dctcg_solver = fft_poisson.DCTPCGSolver.build(grid, bcs, solid)
        mg_solver = None
        if params.poisson.method in ("mg", "mgcg"):
            from .ops import multigrid

            mg_solver = multigrid.MGPoissonSolver.build(
                grid, bcs, solid,
                sdf=sdf if sharp_pressure else None,
            )
        per = bcs_mod.periodic_axes(grid, bcs)
        if cut is not None:
            # cut-cell masks: a face is a velocity DOF iff its aperture is
            # open; corrections apply on every open interior face -- the
            # exact consistency triple with divergence_ap + the cut op
            ap_np = cut[0]
            face_masks = tuple(
                jnp.asarray((np.asarray(a) > 0).astype(np.float64),
                            grid.dtype)
                for a in ap_np
            )
            nd = grid.ndim
            corr_masks = tuple(
                jnp.asarray(
                    (np.asarray(ap_np[a])[tuple(
                        slice(1, -1) if d == a else slice(None)
                        for d in range(nd)
                    )] > 0).astype(np.float64),
                    grid.dtype,
                )
                for a in range(nd)
            )
            op = poisson_mod.build_poisson_op_cut(grid, bcs, ap_np, cut[1])
        else:
            face_masks = bcs_mod.face_masks_from_solid(grid, solid, per)
            corr_masks = bcs_mod.correction_face_masks(grid, solid, per)
            op = poisson_mod.build_poisson_op(grid, bcs, solid)
        if sdf is not None and face_masks is not None:
            from . import ibm as ibm_mod

            ibm_op = ibm_mod.build_ibm(grid, bcs, sdf, face_masks,
                                       velocity=surface_velocity)
        return Simulation(
            grid=grid,
            bcs=bcs,
            params=params,
            op=op,
            face_masks=face_masks,
            corr_masks=corr_masks,
            forcing=forcing,
            dct_solver=dct_solver,
            mg_solver=mg_solver,
            dctcg_solver=dctcg_solver,
            scalar=scalar,
            scalar_solid=scalar_solid,
            les=les,
            ibm=ibm_op,
        )

    # -- single step ---------------------------------------------------------

    def initial_state(self) -> State:
        st = zero_state(self.grid)
        # time-dependent BC callables: impose the t=0 values (a callable
        # own-axis inflow value is not face-settable unresolved)
        b = (bcs_mod.resolve_bcs(self.bcs, 0.0)
             if bcs_mod.bcs_time_dependent(self.bcs) else self.bcs)
        u = bcs_mod.apply_velocity_bcs(self.grid, b, st.u, self.face_masks)
        theta = None
        if self.scalar is not None:
            init = getattr(self.scalar, "theta_init", None)
            theta = (jnp.zeros(self.grid.shape, self.grid.dtype)
                     if init is None else jnp.asarray(init, self.grid.dtype))
            if self.scalar_solid is not None:
                from . import scalar as scalar_mod

                theta = scalar_mod.freeze_body(
                    self.scalar, theta, self.scalar_solid
                )
        # extrapolating warm start carries p_prev through the scan (pytree
        # structure must be static, so it is populated from step 0)
        p_prev = st.p if self.params.poisson.extrapolate else None
        t = (jnp.zeros((), self.grid.dtype)
             if self._time_dependent() else None)
        return State(u=u, p=st.p, theta=theta, p_prev=p_prev, t=t)

    def _has_outflow(self) -> bool:
        from .bcs import BCKind

        return any(
            self.bcs[(a, s)].kind in (BCKind.OUTFLOW, BCKind.CONVECTIVE)
            for a in range(self.grid.ndim)
            for s in (0, 1)
        )

    def _constrain(self, state: State) -> State:
        if self.shardings is None:
            return state
        sh = self.shardings
        if (
            (state.theta is not None and sh.theta is None)
            or (state.p_prev is not None and sh.p_prev is None)
            or (state.t is not None and sh.t is None)
        ):
            # theta and p_prev are cell-centered: they share p's
            # decomposition; the scalar time is replicated
            from jax.sharding import NamedSharding, PartitionSpec

            sh = State(
                u=sh.u,
                p=sh.p,
                theta=None if state.theta is None else sh.p,
                p_prev=None if state.p_prev is None else sh.p,
                t=(None if state.t is None
                   else NamedSharding(sh.p.mesh, PartitionSpec())),
            )
        return jax.lax.with_sharding_constraint(state, sh)

    def _step_dt(self, u):
        """Per-step dt: fixed, or CFL-limited from the current velocity."""
        pr = self.params
        dt = jnp.asarray(pr.dt, self.grid.dtype)
        if pr.cfl is None:
            return dt
        h = self.grid.spacing
        vel = jnp.asarray(1e-12, self.grid.dtype)   # max_a max|u_a| / h_a
        for a, comp in enumerate(u):
            vel = jnp.maximum(vel, jnp.max(jnp.abs(comp)) / h[a])
        return jnp.minimum(dt, pr.cfl / vel)

    def _solve_pressure(self, rhs: Array, p0: Array):
        """Dispatch to the configured pressure solver; returns (p, iters, res)."""
        if self.diff_solve:
            from . import adjoint

            return adjoint.implicit_solve(adjoint.base_of(self), rhs, p0)
        pr = self.params
        if self.halo_solver is not None:
            # op (+ mg level ops / dctcg transform arrays) passed
            # explicitly: their arrays are threaded as traced jit
            # arguments (run_scan consts), not baked program constants.
            return self.halo_solver.solve(
                rhs, p0, op=self.op,
                mg_ops=(self.mg_solver.ops
                        if self.mg_solver is not None else None),
                dctcg_consts=getattr(self, "_dctcg_halo", None),
            )
        if self.dct_solver is not None:
            from .ops import fft_poisson

            return fft_poisson.solve_with_residual(
                self.dct_solver, self.op, rhs,
                diag_residual=pr.poisson.diag_residual,
            )
        if self.dctcg_solver is not None:
            return self.dctcg_solver.solve(
                rhs, p0, pr.poisson.tol, pr.poisson.max_iters, op=self.op
            )
        if self.mg_solver is not None:
            mg_solve = (
                self.mg_solver.solve_pcg
                if pr.poisson.method == "mgcg"
                else self.mg_solver.solve
            )
            return mg_solve(rhs, p0, pr.poisson.tol, pr.poisson.max_iters)
        return poisson_mod.solve_poisson(
            self.op, rhs, p0, self.grid, pr.poisson
        )

    def _combined_forcing(self, theta):
        """Static body forcing + Boussinesq buoyancy from the scalar."""
        if self.scalar is None or theta is None:
            return self.forcing
        from . import scalar as scalar_mod

        buoy = scalar_mod.buoyancy_forcing(self.grid, self.scalar, theta)
        if buoy is None:
            return self.forcing
        if self.forcing is None:
            return buoy
        return tuple(
            b if f is None else (f if b is None else f + b)
            for f, b in zip(self.forcing, buoy)
        )

    def _predict(self, u, dt, forcing=None):
        """``u* = u + dt * RHS_adv_diff(u) [+ forcing]``, BC-applied."""
        g, b, pr = self.grid, self.bcs, self.params
        if self.les is not None:
            # Smagorinsky subgrid stress of the CURRENT stage field
            # (recomputed per rk2 stage), merged into `forcing`
            from . import les as les_mod

            sgs = les_mod.sgs_forcing(g, b, u, self.les)
            forcing = (sgs if forcing is None else tuple(
                s if f is None else f + s for f, s in zip(forcing, sgs)
            ))
        u_star = stencils.predictor(
            g, b, u, dt, pr.nu, pr.upwind_gamma, forcing
        )
        return bcs_mod.apply_velocity_bcs(g, b, u_star, self.face_masks)

    def _div(self, u):
        """Divergence consistent with the Poisson operator: apertured
        (cut-cell) fluxes when the op carries face apertures, the plain
        staggered divergence otherwise."""
        if self.op.ap is not None:
            return stencils.divergence_ap(self.grid, u, self.op.ap)
        return stencils.divergence(self.grid, u)

    def _project(self, u_star, p0, dt):
        """Pressure-project ``u*`` to divergence-free: solve the Poisson
        equation and apply the correction. Returns (u_new, p, iters, res)."""
        g, b, pr = self.grid, self.bcs, self.params
        if self.ibm is not None:
            # sharp-interface direct forcing on the first fluid ring
            # (every projection stage sees the interpolated wall values)
            with jax.named_scope("ibm"):
                u_star = self.ibm.apply(u_star)
        with jax.named_scope("poisson"):
            rhs = self._div(u_star) * (pr.rho / dt) * self.op.fluid
            p, iters, res = self._solve_pressure(rhs, p0)
        with jax.named_scope("correction"):
            u_new = stencils.correct_velocity(
                g, u_star, p, dt / pr.rho, self.corr_masks,
                bcs_mod.periodic_axes(g, b),
            )
            if bcs_mod.has_convective_outlet(g, b):
                # convective faces get the Dirichlet-ghost pressure
                # correction the Poisson row assumed for them
                u_new = bcs_mod.correct_convective_faces(
                    g, b, u_new, p, dt / pr.rho
                )
            # The correction only writes interior faces (and mirrors the
            # periodic wrap face itself), so u_new's boundary DOFs still
            # carry u*'s BC values -- re-application is only needed for
            # OUTFLOW faces, whose zero-gradient copy must track the updated
            # interior neighbor.
            if self._has_outflow():
                u_new = bcs_mod.apply_velocity_bcs(
                    g, b, u_new, self.face_masks
                )
                if self.ibm is not None:
                    # the face-mask zeroing above just erased the moving
                    # body's wet-face velocities; restore them so the
                    # post-step state (and its divergence diagnostic at
                    # interface cells) stays consistent
                    u_new = self.ibm.apply_wet(u_new)
        return u_new, p, iters, res

    def _time_dependent(self) -> bool:
        """Any BC velocity entry or forcing component a callable of time."""
        if bcs_mod.bcs_time_dependent(self.bcs):
            return True
        return self.forcing is not None and any(
            callable(f) for f in self.forcing
        )

    def _step_timedep(self, state: State) -> tuple[State, StepDiagnostics]:
        """One step of a time-dependent run: resolve the BC/forcing
        callables against the carried ``state.t``, delegate to the static
        step on a resolved copy of the Simulation, advance t by the dt
        actually used (CFL-adaptive runs included). BC KINDS must not
        change in time (the Poisson operator/masks were built from them);
        only the values may, and they resolve to traced scalars."""
        t = state.t
        b, forcing = self._resolve_timedep(t)
        sim = dataclasses.replace(self, bcs=b, forcing=forcing)
        inner = dataclasses.replace(state, t=None)
        new_state, diag = sim._step_jnp(inner)
        return dataclasses.replace(new_state, t=t + diag.dt), diag

    def _resolve_timedep(self, t):
        """(bcs, forcing) with the time callables evaluated at ``t``."""
        b = bcs_mod.resolve_bcs(self.bcs, t)
        forcing = self.forcing
        if forcing is not None and any(callable(f) for f in forcing):
            forcing = tuple(f(t) if callable(f) else f for f in forcing)
        return b, forcing

    def step(self, state: State) -> tuple[State, StepDiagnostics]:
        if state.t is not None:
            return self._step_timedep(state)
        return self._step_jnp(state)

    def _step_jnp(self, state: State) -> tuple[State, StepDiagnostics]:
        """One projection step in plain jnp/lax (GSPMD-sharded when
        ``shardings`` is set), for time-independent BCs and forcing."""
        g, b, pr = self.grid, self.bcs, self.params
        state = self._constrain(state)
        with jax.named_scope("bcs"):
            u = bcs_mod.apply_velocity_bcs(g, b, state.u, self.face_masks)
            if self.ibm is not None:
                # re-impose the interpolated surface values the correction
                # perturbed (and the wet-solid body velocity for moving
                # boundaries, which the face-mask zeroing just erased)
                u = self.ibm.apply(u)
        dt = self._step_dt(u)
        forcing = self._combined_forcing(state.theta)
        # Warm start for the iterative pressure solve: linear extrapolation
        # 2 p_n - p_{n-1} when enabled (PoissonConfig.extrapolate), else the
        # previous pressure.
        beta = pr.poisson.extrapolate
        if beta and state.p_prev is not None:
            p_start = state.p + beta * (state.p - state.p_prev)
        else:
            p_start = state.p
        p_prev_new = state.p if state.p_prev is not None else None
        if pr.integrator == "rk2":
            # Midpoint rule with a projection per stage: advance half a step,
            # project, then advance the FULL step using the midpoint field's
            # advection-diffusion RHS (u* = u + dt*RHS(u_half)); second-order
            # in time where Euler is first-order (SURVEY.md SS0.3 integrator
            # TODO: the reference's order is unknown, both are offered).
            with jax.named_scope("predictor"):
                uh_star = self._predict(u, 0.5 * dt, forcing)
            if bcs_mod.has_convective_outlet(g, b):
                uh_star = bcs_mod.apply_convective_outlets(
                    g, b, uh_star, state.u, 0.5 * dt
                )
            uh, ph, it1, _ = self._project(uh_star, p_start, 0.5 * dt)
            with jax.named_scope("predictor2"):
                adv = self._predict(uh, dt, forcing)
                u_star = tuple(a + (b2 - b1) for a, b2, b1 in zip(u, adv, uh))
                u_star = bcs_mod.apply_velocity_bcs(
                    g, b, u_star, self.face_masks
                )
            if bcs_mod.has_convective_outlet(g, b):
                u_star = bcs_mod.apply_convective_outlets(
                    g, b, u_star, state.u, dt
                )
            u_new, p, iters, res = self._project(u_star, ph, dt)
            iters = iters + it1
        elif pr.integrator == "euler":
            with jax.named_scope("predictor"):
                u_star = self._predict(u, dt, forcing)
            if bcs_mod.has_convective_outlet(g, b):
                u_star = bcs_mod.apply_convective_outlets(
                    g, b, u_star, state.u, dt
                )
            u_new, p, iters, res = self._project(u_star, p_start, dt)
        else:
            raise ValueError(f"unknown integrator {pr.integrator!r}")
        theta_new = state.theta
        if self.scalar is not None and state.theta is not None:
            # Advance the scalar with the end-of-step (divergence-free)
            # velocity; explicit Euler sub-step (first-order splitting of
            # the buoyancy coupling -- the momentum temporal order is
            # unchanged for passive scalars).
            from . import scalar as scalar_mod

            with jax.named_scope("scalar"):
                theta_new = state.theta + dt * scalar_mod.scalar_rhs(
                    g, self.scalar, u_new, state.theta,
                    solid=self.scalar_solid,
                )
                if self.scalar_solid is not None:
                    # solid cells are frozen: clamped to the body value
                    # (isothermal) or held at their previous value
                    # (adiabatic -- no flux crosses the interface, so
                    # their evolution is meaningless garbage)
                    theta_new = jnp.where(
                        self.scalar_solid,
                        scalar_mod.freeze_body(
                            self.scalar, state.theta, self.scalar_solid
                        ),
                        theta_new,
                    )
        new_state = self._constrain(
            State(u=u_new, p=p, theta=theta_new, p_prev=p_prev_new)
        )
        with jax.named_scope("diagnostics"):
            div = self._div(new_state.u) * self.op.fluid
            diag = StepDiagnostics(
                poisson_iters=iters,
                poisson_res=res,
                max_div=jnp.max(jnp.abs(div)),
                max_cfl=stencils.max_cfl(g, new_state.u, dt),
                dt=dt,
            )
        return new_state, diag

    def make_step_fn(self):
        def step_fn(state: State, _=None):
            return self.step(state)

        return step_fn

    # -- scan runner ---------------------------------------------------------

    # -- large-array threading -----------------------------------------------
    # Simulation's per-cell arrays (Poisson diag/code, the spectral
    # inverse-eigenvalue tensor, multigrid levels, masks, forcing) would
    # otherwise be baked into the jitted program as CONSTANTS -- ~150 MB of
    # program at 256^3 and >1 GB at 512^3, which bloats every executable
    # and its compile. run_scan threads them through as traced arguments
    # instead.

    def _consts(self):
        c = self._solver_consts()
        c["forcing"] = self.forcing
        c["scalar_solid"] = self.scalar_solid
        if self.forcing is not None and any(
            callable(f) for f in self.forcing
        ):
            # time-dependent forcing callables cannot ride a jit pytree;
            # they stay static on the sim (_bind keeps self.forcing), and
            # any concrete arrays mixed into the tuple become program
            # constants for that run
            c["forcing"] = None
        return c

    def _solver_consts(self):
        """The per-cell arrays the PRESSURE-SOLVE dispatch reads, as a
        pytree -- the subset of ``_consts()`` that adjoint.py must hoist
        across its custom-VJP boundary explicitly (closure_convert would
        bake integer-dtype tracers like the uint8 stencil code, leaking
        them into the lowered program). Shaped so ``_bind`` accepts it."""
        c = {
            "op": self.op,
            "face_masks": self.face_masks,
            "corr_masks": self.corr_masks,
            # never read by _solve_pressure; None makes _bind keep self's
            "forcing": None,
        }
        if self.dct_solver is not None:
            c["inv_eig"] = self.dct_solver.inv_eig
        if self.dctcg_solver is not None:
            d = self.dctcg_solver
            c["dctcg_inv_eig"] = d.dct.inv_eig
            c["dctcg_cap"] = (
                d.cap_wbox, d.cap_cinv, d.cap_vx, d.cap_vy,
                d.cap_fx, d.cap_fy, d.cap_va, d.cap_vb,
            )
        if (self.halo_solver is not None
                and getattr(self.halo_solver, "dctcg_consts", None)
                is not None):
            # explicit-halo dctcg: the dense per-axis transform matrices
            # + natural-layout spectral multiplier ride as traced args too
            c["dctcg_halo"] = self.halo_solver.dctcg_consts
        if self.mg_solver is not None:
            c["mg_ops"] = self.mg_solver.ops
        if self.ibm is not None:
            # not read by the solve either, but _bind unpacks it when set
            c["ibm"] = (self.ibm.masks, self.ibm.w, self.ibm.band,
                        self.ibm.ub, self.ibm.wet, self.ibm.ub_wet)
        return c

    def _bind(self, c) -> "Simulation":
        """A copy of this Simulation whose big arrays are the (traced)
        pytree ``c`` -- used inside jit so they arrive as arguments."""
        dct = self.dct_solver
        if dct is not None:
            dct = dataclasses.replace(dct, inv_eig=c["inv_eig"])
        dctcg = self.dctcg_solver
        if dctcg is not None:
            wbox, cinv, vx, vy, fx, fy, va, vb = c["dctcg_cap"]
            inner = dataclasses.replace(
                dctcg.dct, inv_eig=c["dctcg_inv_eig"]
            )
            dctcg = dataclasses.replace(
                dctcg,
                dct=inner,
                cap_wbox=wbox, cap_cinv=cinv, cap_vx=vx, cap_vy=vy,
                cap_fx=fx, cap_fy=fy, cap_va=va, cap_vb=vb,
            )
        mg = self.mg_solver
        if mg is not None:
            mg = dataclasses.replace(mg, ops=c["mg_ops"])
        ibm = self.ibm
        if ibm is not None:
            masks, w, band, ub, wet, ub_wet = c["ibm"]
            ibm = dataclasses.replace(ibm, masks=masks, w=w, band=band,
                                      ub=ub, wet=wet, ub_wet=ub_wet)
        bound = dataclasses.replace(
            self,
            op=c["op"],
            face_masks=c["face_masks"],
            corr_masks=c["corr_masks"],
            forcing=self.forcing if c["forcing"] is None else c["forcing"],
            scalar_solid=c.get("scalar_solid", self.scalar_solid),
            dct_solver=dct,
            dctcg_solver=dctcg,
            mg_solver=mg,
            ibm=ibm,
        )
        if "dctcg_halo" in c:
            object.__setattr__(bound, "_dctcg_halo", c["dctcg_halo"])
        # the unbound (concrete-array) template: adjoint.py needs a
        # tracer-free static to carry across its custom-VJP boundary
        object.__setattr__(bound, "_shell", self)
        return bound

    def run_scan(self, state: State, n_steps: int) -> tuple[State, StepDiagnostics]:
        """Advance ``n_steps`` inside a single jitted ``lax.scan``.

        Returns the final state and per-step stacked diagnostics. Compiles
        once per (shape, n_steps).
        """
        return _run_scan_jit(self, self._consts(), state, n_steps)

    def run_scan_stats(
        self, state: State, n_steps: int, stats=None
    ) -> tuple[State, StepDiagnostics, "object"]:
        """Advance ``n_steps`` while accumulating running flow statistics
        (time-mean fields + Reynolds stresses; see stats.py).

        The accumulator is carried through the scan -- O(grid) memory, no
        per-step stacking, no host round-trips. Pass the returned ``stats``
        back in to continue accumulating across chunks.
        """
        from . import stats as stats_mod

        if stats is None:
            stats = stats_mod.init_stats(
                self.grid, with_theta=state.theta is not None
            )
        return _run_scan_stats_jit(self, self._consts(), state, stats, n_steps)


    def run_scan_tracers(
        self, state: State, pos: Array, n_steps: int
    ) -> tuple[State, Array, StepDiagnostics, Array]:
        """Advance ``n_steps`` while advecting Lagrangian tracer particles
        (tracers.py) with the end-of-step velocity and the step's actual
        dt (CFL-adaptive aware). Returns ``(state, pos, diags, traj)``
        with ``traj`` shaped ``(n_steps, n, ndim)`` -- the full particle
        trajectories, stacked on device inside the scan."""
        return _run_scan_tracers_jit(self, self._consts(), state, pos, n_steps)

    def run_scan_forces(
        self, state: State, n_steps: int, box
    ) -> tuple[State, StepDiagnostics, Array, Array]:
        """Advance ``n_steps`` sampling control-volume force terms EVERY
        step (utils/forces.cv_terms_nd over the static cell ``box``).

        Returns ``(state, diags, sf, mom)`` with ``sf``/``mom`` shaped
        ``(n_steps, ndim)``: per-step surface-force and CV-momentum
        series, ready for ``drag_lift_series(dt_sample=dt)``. Chunked
        host-side sampling (the CLI window loop) undersamples a shedding
        period; in-scan sampling costs a few slice reductions per step and
        resolves the full Cd/Cl waveform.
        """
        return _run_scan_forces_jit(
            self, self._consts(), state, n_steps, tuple(int(b) for b in box)
        )


@partial(jax.jit, static_argnums=(0, 4))
def _run_scan_tracers_jit(
    sim: Simulation, consts, state: State, pos: Array, n_steps: int
):
    from . import tracers as tracers_mod

    sim = sim._bind(consts)

    def body(carry, _):
        st, p = carry
        st, diag = sim.step(st)
        p = tracers_mod.advect_tracers(sim.grid, sim.bcs, st.u, p, diag.dt)
        return (st, p), (diag, p)

    (state, pos), (diags, traj) = jax.lax.scan(
        body, (state, pos), xs=None, length=n_steps
    )
    return state, pos, diags, traj


@partial(jax.jit, static_argnums=(0, 3, 4))
def _run_scan_forces_jit(
    sim: Simulation, consts, state: State, n_steps: int, box
):
    from .utils.forces import cv_terms_nd

    sim = sim._bind(consts)

    def body(st, _):
        st, diag = sim.step(st)
        sf, mom = cv_terms_nd(sim.grid, st, sim.params.nu, box)
        return st, (diag, jnp.stack(sf), jnp.stack(mom))

    state, (diags, sf, mom) = jax.lax.scan(
        body, state, xs=None, length=n_steps
    )
    return state, diags, sf, mom


@partial(jax.jit, static_argnums=(0, 4))
def _run_scan_stats_jit(sim: Simulation, consts, state: State, stats, n_steps: int):
    from . import stats as stats_mod

    sim = sim._bind(consts)

    def body(carry, _):
        st, acc = carry
        st, diag = sim.step(st)
        return (st, stats_mod.accumulate(sim.grid, acc, st)), diag

    if sim.diff_solve:
        # same per-step remat as _run_scan_jit's diff branch (memory +
        # the GSPMD uneven-shard residual-stacking NaN fix)
        body = jax.checkpoint(body)
    (state, stats), diags = jax.lax.scan(
        body, (state, stats), xs=None, length=n_steps
    )
    return state, diags, stats


@partial(jax.jit, static_argnums=(0, 3))
def _run_scan_jit(sim: Simulation, consts, state: State, n_steps: int):
    # `sim` is hashable-by-id static; its big arrays arrive via `consts`
    # (traced jit arguments, NOT embedded program constants).
    sim = sim._bind(consts)
    step_fn = sim.make_step_fn()
    if sim.diff_solve:
        # Reverse-mode runs remat each step from its carry (the standard
        # O(1)-residual trade). This is also a CORRECTNESS fix under
        # sharding: without it the scan transpose stacks per-step
        # residuals whose leading grid axis is unevenly sharded (n+1
        # staggered faces over the mesh), and slicing those stacked
        # residuals in the backward scan read GSPMD shard padding --
        # observed as NaN cotangents (3D cavity, cg, >= 2 steps).
        step_fn = jax.checkpoint(step_fn)
    return jax.lax.scan(step_fn, state, xs=None, length=n_steps)


def steady_state_delta(prev: State, new: State, dt: float) -> float:
    """max |u_new - u_prev| / dt -- host-side steady-state check between chunks."""
    d = 0.0
    for a, b in zip(prev.u, new.u):
        d = max(d, float(jnp.max(jnp.abs(a - b))))
    return d / dt
