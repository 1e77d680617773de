"""Running flow statistics accumulated inside the jitted scan.

Time-averaged fields and Reynolds stresses are the standard deliverable of
an unsteady CFD run (turbulence, vortex shedding). The device-resident
shape of the problem: the accumulator is a pytree carried through ``lax.scan``
alongside the state, so collecting statistics costs a few fused elementwise
passes per step and ZERO host round-trips; nothing is stacked per step
(memory stays O(grid), independent of run length).

Numerics: Welford's incremental moments, not naive sums. A float32 running
sum loses the new sample's low bits once ``n`` is large (the sum grows, the
increment does not); Welford keeps the carried quantities at the scale of
the fields themselves, so million-step averages stay accurate in f32 --
the dtype the device path runs in.

Update (per step, per field):
    d1    = x - mean            # deviation from OLD mean
    mean' = mean + d1 / n
    M2'   = M2 + d1 * (x - mean')   # variance co-moment
    C'    = C  + d1x * (y - mean_y')  # covariance co-moment (cross terms)

``finalize`` divides by n: Reynolds stresses <u_i' u_j'> = M2/n (population
normalization -- the ensemble here is the time series itself).

Velocities are interpolated to cell centers before accumulation: collocated
moments are what post-processing consumes, and the cross moments
<u'v'> only exist at a common location.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import jax
import jax.numpy as jnp

from .grid import GridSpec, State, interpolate_to_centers

Array = jax.Array


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FlowStats:
    """Welford accumulator over cell-centered fields.

    ``mean_u``/``m2_u`` have one entry per velocity component; ``c_uv`` has
    one entry per unordered component pair, in ``itertools.combinations``
    order: 2D ``(01,)``, 3D ``(01, 02, 12)``. ``theta`` entries are None
    for pure-momentum runs (empty pytree subtrees, structure-stable).
    """

    n: Array                       # scalar sample count (int32: exact up to
                                   # 2^31 -- an f32 counter saturates at 2^24
                                   # samples, silently freezing the means)
    mean_u: tuple[Array, ...]
    m2_u: tuple[Array, ...]
    c_uv: tuple[Array, ...]
    mean_p: Array
    m2_p: Array
    mean_theta: Optional[Array] = None
    m2_theta: Optional[Array] = None

    def tree_flatten(self):
        return (
            (self.n, self.mean_u, self.m2_u, self.c_uv, self.mean_p,
             self.m2_p, self.mean_theta, self.m2_theta),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, mu, m2, cuv, mp, m2p, mt, m2t = children
        return cls(n=n, mean_u=tuple(mu), m2_u=tuple(m2), c_uv=tuple(cuv),
                   mean_p=mp, m2_p=m2p, mean_theta=mt, m2_theta=m2t)


def pair_indices(ndim: int) -> tuple[tuple[int, int], ...]:
    """Component pairs of the off-diagonal Reynolds-stress entries."""
    return tuple(itertools.combinations(range(ndim), 2))


def init_stats(grid: GridSpec, with_theta: bool = False) -> FlowStats:
    """Zero accumulator matching the grid's cell-centered shapes."""
    z = lambda: jnp.zeros(grid.shape, grid.dtype)  # noqa: E731
    nd = grid.ndim
    return FlowStats(
        n=jnp.zeros((), jnp.int32),
        mean_u=tuple(z() for _ in range(nd)),
        m2_u=tuple(z() for _ in range(nd)),
        c_uv=tuple(z() for _ in pair_indices(nd)),
        mean_p=z(),
        m2_p=z(),
        mean_theta=z() if with_theta else None,
        m2_theta=z() if with_theta else None,
    )


def _welford(mean: Array, m2: Array, x: Array, inv_n: Array):
    d1 = x - mean
    mean_new = mean + d1 * inv_n
    return mean_new, m2 + d1 * (x - mean_new), d1


def accumulate(grid: GridSpec, stats: FlowStats, state: State) -> FlowStats:
    """One Welford update from ``state``. Pure; safe inside scan/jit."""
    n = stats.n + 1
    # The ratio is formed in the field dtype; the int32 count stays exact
    # (the f32 cast of n loses bits past 2^24 but only perturbs inv_n by
    # ~1e-7 relative, not the sample count itself).
    inv_n = 1.0 / n.astype(state.p.dtype)
    uc = interpolate_to_centers(grid, state.u)
    mean_u, m2_u, d1 = [], [], []
    for a, x in enumerate(uc):
        m, s, d = _welford(stats.mean_u[a], stats.m2_u[a], x, inv_n)
        mean_u.append(m)
        m2_u.append(s)
        d1.append(d)
    c_uv = tuple(
        c + d1[i] * (uc[j] - mean_u[j])
        for c, (i, j) in zip(stats.c_uv, pair_indices(grid.ndim))
    )
    mean_p, m2_p, _ = _welford(stats.mean_p, stats.m2_p, state.p, inv_n)
    mean_theta, m2_theta = stats.mean_theta, stats.m2_theta
    if mean_theta is not None and state.theta is not None:
        mean_theta, m2_theta, _ = _welford(
            mean_theta, m2_theta, state.theta, inv_n
        )
    return FlowStats(
        n=n, mean_u=tuple(mean_u), m2_u=tuple(m2_u), c_uv=c_uv,
        mean_p=mean_p, m2_p=m2_p,
        mean_theta=mean_theta, m2_theta=m2_theta,
    )


def to_arrays(stats: FlowStats) -> dict:
    """Flatten to named numpy arrays (checkpoint serialization)."""
    import numpy as np

    out = {"n": np.asarray(stats.n)}
    for a, x in enumerate(stats.mean_u):
        out[f"mean_u_{a}"] = np.asarray(x)
        out[f"m2_u_{a}"] = np.asarray(stats.m2_u[a])
    for i, c in enumerate(stats.c_uv):
        out[f"c_uv_{i}"] = np.asarray(c)
    out["mean_p"] = np.asarray(stats.mean_p)
    out["m2_p"] = np.asarray(stats.m2_p)
    if stats.mean_theta is not None:
        out["mean_theta"] = np.asarray(stats.mean_theta)
        out["m2_theta"] = np.asarray(stats.m2_theta)
    return out


def from_arrays(d: dict, dtype) -> FlowStats:
    """Inverse of :func:`to_arrays`."""
    nd = sum(1 for k in d if k.startswith("mean_u_"))
    j = lambda k: jnp.asarray(d[k], dtype)  # noqa: E731
    return FlowStats(
        n=jnp.asarray(d["n"], jnp.int32),  # f32 in pre-int32 checkpoints
        mean_u=tuple(j(f"mean_u_{a}") for a in range(nd)),
        m2_u=tuple(j(f"m2_u_{a}") for a in range(nd)),
        c_uv=tuple(j(f"c_uv_{i}") for i in range(len(pair_indices(nd)))),
        mean_p=j("mean_p"),
        m2_p=j("m2_p"),
        mean_theta=j("mean_theta") if "mean_theta" in d else None,
        m2_theta=j("m2_theta") if "m2_theta" in d else None,
    )


def finalize(stats: FlowStats) -> dict:
    """Moments -> named fields. Keys: ``u_mean_<i>``, ``p_mean``,
    ``theta_mean``, Reynolds stresses ``uu_<i><j>`` (i<=j), ``p_var``,
    ``theta_var``, plus the sample count ``n``."""
    import numpy as np

    n = float(stats.n)
    if n <= 0:
        raise ValueError("no samples accumulated")
    out = {"n": np.asarray(n)}
    nd = len(stats.mean_u)
    for a in range(nd):
        out[f"u_mean_{a}"] = np.asarray(stats.mean_u[a])
        out[f"uu_{a}{a}"] = np.asarray(stats.m2_u[a]) / n
    for c, (i, j) in zip(stats.c_uv, pair_indices(nd)):
        out[f"uu_{i}{j}"] = np.asarray(c) / n
    out["p_mean"] = np.asarray(stats.mean_p)
    out["p_var"] = np.asarray(stats.m2_p) / n
    if stats.mean_theta is not None:
        out["theta_mean"] = np.asarray(stats.mean_theta)
        out["theta_var"] = np.asarray(stats.m2_theta) / n
    return out
