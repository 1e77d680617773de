"""Taylor-Green vortex in a fully periodic box -- the analytic-decay oracle.

Exact incompressible Navier-Stokes solution on [0, 2pi]^2:
    u(x, y, t) =  cos(x) sin(y) exp(-2 nu t)
    v(x, y, t) = -sin(x) cos(y) exp(-2 nu t)
    p(x, y, t) = -(cos 2x + cos 2y)/4 exp(-4 nu t)
Every mode decays at the viscous rate; the nonlinear term is exactly
balanced by the pressure gradient, so the numerical solution must track the
analytic field to discretization order. This exercises the periodic BC path
end-to-end (wrap stencils, circulant spectral solve, wrap correction).
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..bcs import BCSpec
from ..grid import GridSpec, State
from ..solver import SimParams, Simulation
from ..ops.poisson import PoissonConfig


def taylor_green_state(grid: GridSpec, t: float, nu: float) -> State:
    """Analytic staggered-sampled Taylor-Green field at time ``t``."""
    (nx, ny) = grid.shape
    hx, hy = grid.spacing
    decay = math.exp(-2.0 * nu * t)
    # u faces: x at i*hx (i = 0..nx), y at cell centers (j+1/2)*hy
    xu = np.arange(nx + 1) * hx
    yu = (np.arange(ny) + 0.5) * hy
    u = np.cos(xu)[:, None] * np.sin(yu)[None, :] * decay
    # v faces: x at centers, y at j*hy
    xv = (np.arange(nx) + 0.5) * hx
    yv = np.arange(ny + 1) * hy
    v = -np.sin(xv)[:, None] * np.cos(yv)[None, :] * decay
    xp = (np.arange(nx) + 0.5) * hx
    yp = (np.arange(ny) + 0.5) * hy
    p = -(np.cos(2 * xp)[:, None] + np.cos(2 * yp)[None, :]) / 4.0 * decay**2
    return State(
        u=(jnp.asarray(u, grid.dtype), jnp.asarray(v, grid.dtype)),
        p=jnp.asarray(p, grid.dtype),
    )


def build_taylor_green(
    shape=(64, 64),
    re: float = 100.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    **params_kw,
):
    from . import Case

    grid = GridSpec(
        shape=tuple(shape), lengths=(2.0 * math.pi, 2.0 * math.pi),
        dtype=dtype or jnp.float32,
    )
    bcs = {
        (a, s): BCSpec.periodic() for a in range(2) for s in (0, 1)
    }
    nu = 1.0 / re
    if dt is None:
        h = min(grid.spacing)
        dt = min(0.25 * h, 0.2 * h * h / nu)  # CFL (u ~ 1) + diffusive limit
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
        **params_kw,
    )
    sim = Simulation.build(grid, bcs, params)
    case = Case(
        name="taylor_green",
        sim=sim,
        suggested_steps=int(round(1.0 / dt)),
        description="2D Taylor-Green vortex, fully periodic (analytic decay)",
    )
    # analytic initial condition (t = 0)
    case.initial_state = lambda: taylor_green_state(grid, 0.0, nu)
    return case


def taylor_green3d_state(grid: GridSpec, amp: float = 1.0) -> State:
    """Classic 3D Taylor-Green initial field on [0, 2pi]^3 (staggered
    sampling): u = sin x cos y cos z, v = -cos x sin y cos z, w = 0.
    Divergence-free analytically AND discretely (the MAC divergence of the
    staggered-sampled field telescopes the same product structure)."""
    nx, ny, nz = grid.shape
    hx, hy, hz = grid.spacing

    def nodes(n, h):
        return np.arange(n + 1) * h

    def centers(n, h):
        return (np.arange(n) + 0.5) * h

    xu, yu, zu = nodes(nx, hx), centers(ny, hy), centers(nz, hz)
    u = (amp * np.sin(xu)[:, None, None] * np.cos(yu)[None, :, None]
         * np.cos(zu)[None, None, :])
    xv, yv, zv = centers(nx, hx), nodes(ny, hy), centers(nz, hz)
    v = (-amp * np.cos(xv)[:, None, None] * np.sin(yv)[None, :, None]
         * np.cos(zv)[None, None, :])
    w = np.zeros((nx, ny, nz + 1))
    return State(
        u=(jnp.asarray(u, grid.dtype), jnp.asarray(v, grid.dtype),
           jnp.asarray(w, grid.dtype)),
        p=jnp.zeros(grid.shape, grid.dtype),
    )


def build_taylor_green3d(
    shape=(128, 128, 128),
    re: float = 1600.0,   # the canonical 3D TGV transition benchmark Re
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.0,
    dtype=None,
    **params_kw,
):
    """3D Taylor-Green vortex (periodic box): the classic vortex-stretching
    / transition-to-turbulence benchmark (Brachet et al. 1983). Unlike 2D
    there is no closed-form solution; the standard oracle is the kinetic
    energy / dissipation-rate history."""
    from . import Case

    grid = GridSpec(shape=tuple(shape), lengths=(2.0 * math.pi,) * 3,
                    dtype=dtype or jnp.float32)
    bcs = {(a, s): BCSpec.periodic() for a in range(3) for s in (0, 1)}
    nu = 1.0 / re
    if dt is None:
        h = min(grid.spacing)
        dt = min(0.25 * h, 0.2 * h * h / nu)
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters
        ),
        **params_kw,
    )
    sim = Simulation.build(grid, bcs, params)
    case = Case(
        name="taylor_green3d",
        sim=sim,
        suggested_steps=int(round(10.0 / dt)),  # t=10 covers the peak-
        description="3D Taylor-Green vortex (periodic; vortex stretching)",
    )
    case.initial_state = lambda: taylor_green3d_state(grid)
    return case
