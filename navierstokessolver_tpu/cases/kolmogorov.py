"""Kolmogorov flow: a periodic box driven by a sinusoidal body force.

The classic forced-turbulence benchmark (public numerics; the reference
mount was empty this session -- SURVEY.md SS0 -- so this is a
beyond-spec case): force ``f = (A sin(k_f y), 0[, 0])`` on a fully
periodic domain. The laminar balance ``nu lap(u) + f = 0`` has the exact
steady solution

    u_lam(y) = A / (nu k_f^2) * sin(k_f y),

stable at low Reynolds number (the tests' oracle) and unstable above
``Re ~ sqrt(2)`` in the standard normalization, giving sustained 2D
turbulence. Exercises the spatially-varying forcing path end to end.

Normalization: ``Re = U_lam / (nu k_f)`` with ``U_lam = A/(nu k_f^2)``,
i.e. ``Re = A / (nu^2 k_f^3)`` -- so given (re, amp, k_f):
``nu = sqrt(amp / (re * k_f**3))``.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..bcs import BCSpec
from ..grid import GridSpec
from ..ops.poisson import PoissonConfig
from ..solver import SimParams, Simulation


def build_kolmogorov(
    shape=(256, 256),
    re: float = 30.0,
    k_forcing: int = 4,
    amp: float = 1.0,
    dt: float | None = None,
    poisson_method: str = "fft",
    poisson_tol: float = 1e-5,
    poisson_iters: int = 2000,
    upwind_gamma: float = 0.05,
    dtype=None,
    **params_kw,
):
    """2D or 3D (len(shape) picks the rank) Kolmogorov flow in a [0, 2pi)^d
    periodic box. The force acts on the x-velocity and varies along y."""
    from . import Case

    nd = len(shape)
    L = 2.0 * math.pi
    grid = GridSpec(shape=tuple(shape), lengths=(L,) * nd,
                    dtype=dtype or jnp.float32)
    bcs = {(a, s): BCSpec.periodic() for a in range(nd) for s in (0, 1)}
    kf = int(k_forcing)
    nu = math.sqrt(amp / (float(re) * kf ** 3))
    u_lam = amp / (nu * kf * kf)

    # f_x at the u faces (periodic own axis: all n distinct faces, shape ==
    # grid.shape); x-face y-coordinates are the cell centers.
    yc = np.asarray(grid.cell_centers(1))
    fx = amp * np.sin(kf * yc)
    fshape = [1] * nd
    fshape[1] = -1
    fx = np.broadcast_to(fx.reshape(fshape), grid.shape)
    forcing = (jnp.asarray(fx, grid.dtype),) + (None,) * (nd - 1)

    if dt is None:
        h = min(grid.spacing)
        umax = max(1.5 * u_lam, 1e-12)
        dt = 0.3 * min(h / umax, h * h / (4.0 * nu))
    params_kw.setdefault("integrator", "rk2")
    params = SimParams(
        dt=dt,
        nu=nu,
        upwind_gamma=upwind_gamma,
        **params_kw,
        poisson=PoissonConfig(
            method=poisson_method, tol=poisson_tol, max_iters=poisson_iters,
        ),
    )
    sim = Simulation.build(grid, bcs, params, forcing=forcing)
    return Case(
        name="kolmogorov",
        sim=sim,
        suggested_steps=int(20.0 / dt),
        description=(
            f"Kolmogorov flow Re={re} k_f={kf} {shape} "
            f"(U_lam={u_lam:.3g}, nu={nu:.3g})"
        ),
    )
