"""Reverse-mode differentiable pressure solve (implicit function theorem).

The iterative Poisson solvers run inside ``lax.while_loop``, which JAX
cannot reverse-differentiate, and unrolling an O(100)-iteration Krylov/
relaxation tape would be both wrong-sized for device memory and numerically
fragile. Instead this module exploits that the *converged* pressure is the
solution of a LINEAR system:

    p = S b,   S = D A^+ D,   D = M - (1/N) f f^T  (fluid mask + nullspace
                                                    deflation projector)

where ``A`` is the masked Laplacian of ops/poisson.py. ``A`` is symmetric by
construction (neighbor couplings are mutual ``1/h_a^2`` presence bits, solid
rows are identity rows decoupled from fluid, outflow faces contribute
diagonal-only terms) and ``D`` is a symmetric projector, so ``S^T = S``: the
vector-Jacobian product of the solve is *the same solve* applied to the
incoming cotangent,

    cot_b = S^T g = solve(g).

That is the implicit-function-theorem custom VJP implemented here. It wraps
the Simulation's solver *dispatch*, not one particular method, so every
configured backend (jacobi/gs/sor/cg, mg/mgcg, the direct DCT solve, dctcg,
and the explicit-halo tier) becomes differentiable: forward and backward are
both matrix-free fixed-structure loops under jit -- no O(iters) memory, no
host round-trips, scan/shard_map friendly.

The warm start ``p0`` only changes how many iterations the solve takes, not
(to solver tolerance) the solution, so its cotangent is zero -- this also
cleanly cuts the ``p -> p_prev -> p_start`` extrapolation recurrence out of
the backward graph. Accuracy of the gradient is O(solver tol); use a tight
tol (and f64 on CPU) when validating against finite differences.

Capability note: the reference class has no differentiable solver
(SURVEY.md SS2; the reference mount is empty -- no file:line citation is
possible). This is a capability beyond it.

Scope (what differentiates, and at what cost):

====================  =========  =======================================
surface               grad?      notes
====================  =========  =======================================
jnp step, unsharded   yes        FD-validated (tests/test_adjoint.py):
                                 cg / fft / jacobi, 2D and 3D
GSPMD sharded step    yes        FD-validated on the virtual 8-dev mesh
poisson_comm="halo"   yes        FD-validated; the backward solve reuses
                                 the same shard_map + ppermute loop
forcing fields        yes        the per-face arrays ride _consts as
                                 traced jit args; grad flows into them
BC values / dt        yes        traced scalars (lid-recovery test)
cut-cell / IBM        forward    geometry arrays get zero cotangents
                      only       (case geometry, never differentiated)
====================  =========  =======================================
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


def differentiable(sim):
    """A copy of ``sim`` whose pressure solves are reverse-differentiable.

    ``jax.grad`` then flows through ``sim.step`` / ``sim.run_scan`` (e.g.
    with respect to the initial state, forcing arrays, or time-dependent BC
    parameters closed over via ``lambda t: param``); the step's pressure
    solves carry the IFT custom VJP.
    """
    if sim.diff_solve:
        return sim
    d = dataclasses.replace(sim, diff_solve=True)
    # pre-populate the non-differentiable replica cache so repeated
    # _solve_pressure calls inside one trace share a single static object
    # (ADVICE r2: a fresh dataclasses.replace per call would hand custom_vjp
    # a new identity-hashed static every time)
    object.__setattr__(d, "_adjoint_base", dataclasses.replace(
        d, diff_solve=False
    ))
    return d


def base_of(sim):
    """The cached ``diff_solve=False`` replica of ``sim`` (creating and
    caching it on first use). The ``_shell`` backpointer (the unbound,
    concrete-array template set by solver.py ``_bind``) is preserved:
    dataclasses.replace only copies declared fields."""
    base = getattr(sim, "_adjoint_base", None)
    if base is None:
        base = dataclasses.replace(sim, diff_solve=False)
        shell = getattr(sim, "_shell", None)
        if shell is not None:
            object.__setattr__(base, "_shell", shell)
        object.__setattr__(sim, "_adjoint_base", base)
    return base


def implicit_solve(base_sim, rhs, p0):
    """``base_sim._solve_pressure(rhs, p0)`` with the IFT custom VJP.

    ``base_sim`` must have ``diff_solve=False`` (solver.py dispatches via
    :func:`base_of`). Returns ``(p, iters, res)`` like every solver;
    ``iters``/``res`` are diagnostics and carry no gradient.

    Inside ``run_scan`` the Simulation's operator arrays (stencil code,
    diagonal, spectral eigenvalues, MG levels, ...) are TRACED jit
    arguments, not concrete constants (solver.py ``_bind``). A static that
    contains tracers cannot ride ``custom_vjp``'s nondiff slot, and
    ``jax.closure_convert`` would bake the INTEGER-dtype tracers (the
    uint8 stencil code has a float0 tangent space, so ``_maybe_perturbed``
    declines to hoist it) -- leaking them into the lowered program. So the
    hoisting is explicit: ``_solver_consts()`` carries every array the
    solve dispatch reads across the VJP boundary as a pytree argument
    (zero/float0 cotangents -- the operator is case geometry, never a
    differentiated quantity), and the tracer-free ``_shell`` template
    rebinds them on the inside.
    """
    if base_sim.diff_solve:  # pragma: no cover - dispatch guard
        raise ValueError("implicit_solve needs the non-differentiable base "
                         "Simulation (use adjoint.base_of)")
    shell = getattr(base_sim, "_shell", base_sim)
    if shell.diff_solve:
        shell = dataclasses.replace(shell, diff_solve=False)
    consts = base_sim._solver_consts()
    return _ift_solve(shell, consts, rhs, p0)


def _zero_cot(x):
    if jnp.issubdtype(x.dtype, jnp.inexact):
        return jnp.zeros(x.shape, x.dtype)
    import numpy as np

    return np.zeros(x.shape, jax.dtypes.float0)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _ift_solve(shell, consts, rhs, p0):
    return shell._bind(consts)._solve_pressure(rhs, p0)


def _ift_fwd(shell, consts, rhs, p0):
    return shell._bind(consts)._solve_pressure(rhs, p0), consts


def _ift_bwd(shell, consts, cot):
    gp = cot[0]
    # The same symmetric solve, from a zero guess: the solver masks the RHS
    # to fluid cells and deflates the constant nullspace internally (exactly
    # the D projector), so lam = S g = S^T g is the rhs cotangent.
    lam, _, _ = shell._bind(consts)._solve_pressure(gp, jnp.zeros_like(gp))
    return (jax.tree_util.tree_map(_zero_cot, consts),
            lam, jnp.zeros_like(gp))


_ift_solve.defvjp(_ift_fwd, _ift_bwd)
