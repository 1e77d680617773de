"""Lid-driven cavity cases (2D and 3D).

BASELINE.json configs #1 (Re=100, 64x64), #4 (Re=10k, 2048^2, CG) and
#5 (3D 256^3). Unit square/cube, no-slip walls, top lid moving at ``lid``
in +x. Validation oracle: Ghia, Ghia & Shin (1982) centerline profiles.
"""

from __future__ import annotations

from ..bcs import BCSpec
from ..grid import GridSpec
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation


def _stable_dt(grid: GridSpec, nu: float, u_max: float, upwind_gamma: float) -> float:
    """Conservative explicit-step limit: diffusive + advective CFL."""
    h = min(grid.spacing)
    ndim = grid.ndim
    dt_diff = h * h / (2.0 * ndim * nu) if nu > 0 else float("inf")
    dt_adv = h / max(u_max, 1e-12)
    return 0.5 * min(dt_diff, dt_adv)


def build_cavity(
    shape=(64, 64),
    re: float = 100.0,
    lid: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "fft",  # closed box: the direct solve always applies
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    poisson_extrapolate: float = 0.0,
    **params_kw,
):
    from . import Case  # local import to avoid a cycle

    import jax.numpy as jnp

    grid = GridSpec(
        shape=tuple(shape),
        lengths=(1.0,) * len(shape),
        dtype=dtype or jnp.float32,
    )
    nu = lid * grid.lengths[0] / re
    nd = grid.ndim
    zeros = (0.0,) * nd
    lid_vel = tuple(lid if a == 0 else 0.0 for a in range(nd))
    bcs = {(a, s): BCSpec.wall(zeros) for a in range(nd) for s in (0, 1)}
    bcs[(nd - 1, 1)] = BCSpec.wall(lid_vel)  # top face (last axis, high side)

    dt = dt if dt is not None else _stable_dt(grid, nu, lid, upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
            # opt-in damped extrapolating warm start for iterative solves
            # (see PoissonConfig.extrapolate); meaningless for fft (1 appl.)
            extrapolate=(poisson_extrapolate
                         if poisson_method != "fft" else 0.0),
        ),
    )
    sim = Simulation.build(grid, bcs, params)
    return Case(
        name="cavity",
        sim=sim,
        suggested_steps=int(25.0 / dt),  # ~t=25 reaches steady state at Re=100
        description=f"lid-driven cavity Re={re} {shape}",
    )


def build_cavity3d(shape=(256, 256, 256), re: float = 1000.0, **kw):
    return build_cavity(shape=shape, re=re, **kw)


def build_oscillating_lid(
    shape=(64, 64, 64),
    re: float = 100.0,
    lid: float = 1.0,
    omega: float = 2.0 * 3.141592653589793,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    poisson_extrapolate: float = 0.0,
    **params_kw,
):
    """Oscillating-lid cavity: the top lid slides at lid*cos(omega t) --
    the canonical time-dependent-BC-VALUE configuration. The run stays one
    jitted lax.scan (BC callables resolve against the carried State.t).
    The unsteady boundary layer is a Stokes layer of thickness
    sqrt(2 nu / omega)."""
    from . import Case

    import jax.numpy as jnp

    grid = GridSpec(
        shape=tuple(shape),
        lengths=(1.0,) * len(shape),
        dtype=dtype or jnp.float32,
    )
    nu = lid * grid.lengths[0] / re
    nd = grid.ndim
    zeros = (0.0,) * nd

    def lid_t(t):
        return lid * jnp.cos(omega * t)

    lid_vel = tuple(lid_t if a == 0 else 0.0 for a in range(nd))
    bcs = {(a, s): BCSpec.wall(zeros) for a in range(nd) for s in (0, 1)}
    bcs[(nd - 1, 1)] = BCSpec.wall(lid_vel)

    dt = dt if dt is not None else _stable_dt(grid, nu, lid, upwind_gamma)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
            extrapolate=(poisson_extrapolate
                         if poisson_method != "fft" else 0.0),
        ),
    )
    sim = Simulation.build(grid, bcs, params)
    period = 2.0 * 3.141592653589793 / omega
    return Case(
        name="oscillating_lid",
        sim=sim,
        suggested_steps=int(5.0 * period / dt),  # five lid periods
        description=f"oscillating-lid cavity Re={re} omega={omega} {shape}",
    )
