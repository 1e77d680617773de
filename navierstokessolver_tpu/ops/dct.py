"""FFT-based DCT-II / inverse along one axis (jit/vmap-safe).

Building block for the direct spectral pressure solve (ops/fft_poisson.py).
Uses the classic even-odd reordering so a length-n real DCT costs one
length-n complex FFT (Makhoul 1980) -- all ops are slices/concats/FFTs.

Conventions (unnormalized, matching scipy.fft.dct type 2):
  DCT2(x)_k = 2 * sum_i x_i cos(pi k (2i+1) / (2n))
  idct2 is its exact inverse.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

Array = jax.Array


def _sl(nd, axis, s):
    idx = [slice(None)] * nd
    idx[axis] = s
    return tuple(idx)


def dct2(x: Array, axis: int = -1) -> Array:
    """Type-II DCT along ``axis`` (unnormalized, scipy-compatible)."""
    n = x.shape[axis]
    nd = x.ndim
    axis = axis % nd
    # even-odd reorder: v = [x0, x2, ..., | ..., x3, x1]
    ev = x[_sl(nd, axis, slice(0, None, 2))]
    od = x[_sl(nd, axis, slice(1, None, 2))]
    v = jnp.concatenate([ev, jnp.flip(od, axis)], axis=axis)
    V = jnp.fft.fft(v, axis=axis)
    k = np.arange(n)
    w = 2.0 * np.exp(-1j * np.pi * k / (2 * n))
    shape = [1] * nd
    shape[axis] = n
    w = jnp.asarray(w.reshape(shape))
    return jnp.real(w * V).astype(x.dtype)


def idct2(X: Array, axis: int = -1) -> Array:
    """Inverse of :func:`dct2` along ``axis``."""
    n = X.shape[axis]
    nd = X.ndim
    axis = axis % nd
    dtype = X.dtype
    k = np.arange(n)
    w = 0.5 * np.exp(1j * np.pi * k / (2 * n))
    shape = [1] * nd
    shape[axis] = n
    w = jnp.asarray(w.reshape(shape))
    # X_flip_k = X_{n-k} (k>=1), 0 at k=0
    Xf = jnp.flip(X, axis)
    zero = jnp.zeros_like(X[_sl(nd, axis, slice(0, 1))])
    Xf = jnp.concatenate([zero, Xf[_sl(nd, axis, slice(0, -1))]], axis=axis)
    c = w * (X - 1j * Xf)
    v = jnp.real(jnp.fft.ifft(c, axis=axis))
    # de-interleave: x[2i] = v[i], x[2i+1] = v[n-1-i]
    half = (n + 1) // 2
    ev = v[_sl(nd, axis, slice(0, half))]          # -> x[0], x[2], ...
    od = jnp.flip(v[_sl(nd, axis, slice(half, None))], axis)  # -> x[1], x[3], ...
    if n % 2 == 0:
        x = jnp.stack([ev, od], axis=axis + 1)
        new_shape = list(X.shape)
        new_shape[axis] = n
        x = x.reshape(new_shape)
    else:
        # odd n: interleave the first half-1 pairs, append the last even entry
        ev_main = ev[_sl(nd, axis, slice(0, half - 1))]
        x = jnp.stack([ev_main, od], axis=axis + 1)
        new_shape = list(X.shape)
        new_shape[axis] = n - 1
        x = x.reshape(new_shape)
        x = jnp.concatenate([x, ev[_sl(nd, axis, slice(half - 1, None))]], axis=axis)
    return x.astype(dtype)


def dct2_matrix(n: int) -> np.ndarray:
    """Dense DCT-II matrix: X = C @ x, C[k,i] = 2 cos(pi k (2i+1)/(2n)).

    The spectral solve applies the transforms as dense matmul chains
    (ops/fft_poisson.py, matmul mode).
    """
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * k * (2 * i + 1) / (2 * n))


def idct2_matrix(n: int) -> np.ndarray:
    """Dense inverse: x = M @ X, M[i,k] = (1/n) * (1/2 if k==0 else cos(...))."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) / n
    m[:, 0] = 0.5 / n
    return m


# ---------------------------------------------------------------------------
# Radix-split DCT application: exact 2x MAC reduction per level.
#
# Symmetric fold of the input x (length n, m = n/2):
#   g[j] = x[j] + x[n-1-j],  d[j] = x[j] - x[n-1-j]      (j < m)
# Then, with theta_j = pi(2j+1)/(2n):
#   X[2r]   = DCT2_m(g)[r]                               (cos(2r theta) is
#                                                         symmetric in j)
#   X[2r+1] = sum_j d_j * 2cos((2r+1) theta_j) = (D @ d)[r]
# where D[r,j] = 2 cos(pi(2r+1)(2j+1)/(4m)) is twice the (orthogonal) DCT-IV
# matrix, so D^{-1} = D^T / (2m) exactly. Unlike Lee's classic recursion
# there is NO 1/(2cos) scaling -- every factor is bounded by 2, so the split
# is as numerically stable as the dense matmul while halving the matmul work
# (two m x m matmuls instead of one n x n). The even half is itself a DCT-II
# and recurses.
# ---------------------------------------------------------------------------


def dct4_matrix_scaled(n: int) -> np.ndarray:
    """D[r, j] = 2 cos(pi (2r+1)(2j+1) / (4n)) (twice the DCT-IV matrix)."""
    r = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    return 2.0 * np.cos(np.pi * (2 * r + 1) * (2 * j + 1) / (4 * n))


def split_levels(n: int, min_base: int = 512) -> int:
    """Levels of radix splitting: halve while even and the base matmul stays
    at least ``min_base`` wide."""
    lev = 0
    while n % 2 == 0 and n // 2 >= min_base:
        n //= 2
        lev += 1
    return lev


class SplitPlan:
    """Precomputed factor matrices for an L-level radix-split DCT-II along
    one axis, plus the transposed factors for the inverse."""

    def __init__(self, n: int, levels: int, dtype):
        self.n = n
        self.levels = levels
        d4 = []
        m = n
        for _ in range(levels):
            m //= 2
            d4.append(jnp.asarray(dct4_matrix_scaled(m), dtype))
        self.d4 = d4                                   # D per level
        self.d4inv = [jnp.asarray(np.asarray(x).T / (2 * x.shape[0]), dtype)
                      for x in d4]
        self.base_fwd = jnp.asarray(dct2_matrix(m), dtype)
        self.base_inv = jnp.asarray(idct2_matrix(m), dtype)


def _interleave0(G: Array, H: Array) -> Array:
    """out[2r] = G[r], out[2r+1] = H[r] along axis 0."""
    st = jnp.stack([G, H], axis=1)
    return st.reshape((G.shape[0] * 2,) + G.shape[1:])


def split_permutation(n: int, levels: int) -> np.ndarray:
    """``perm`` such that block-order output[k'] = natural-order X[perm[k']].

    In block order the transform emits [evens-of-level-0; odds-of-level-0],
    recursively on the even half. Used to pre-permute the spectral
    multiplier so the runtime never interleaves (zero relayouts).
    """
    if levels == 0:
        return np.arange(n)
    m = n // 2
    sub = split_permutation(m, levels - 1)
    return np.concatenate([2 * sub, 2 * np.arange(m) + 1])


def split_dct_apply(
    plan: SplitPlan, x: Array, axis: int, precision, level: int = 0,
    block_order: bool = False,
) -> Array:
    """DCT-II along ``axis``; transformed axis lands at position 0 (same
    convention as ``tensordot(C, x, axes=([1],[axis]))``).

    ``block_order=True`` skips the even/odd interleave and returns outputs
    in the recursive [G; H] block order (see :func:`split_permutation`) --
    contiguous concats only, no strided relayouts.
    """
    nd = x.ndim
    n = x.shape[axis]
    if level == plan.levels:
        return jnp.tensordot(
            plan.base_fwd, x, axes=([1], [axis]), precision=precision
        )
    m = n // 2
    xf = x[_sl(nd, axis, slice(0, m))]
    xr = jnp.flip(x[_sl(nd, axis, slice(m, None))], axis)
    g = xf + xr
    d = xf - xr
    G = split_dct_apply(plan, g, axis, precision, level + 1, block_order)
    H = jnp.tensordot(
        plan.d4[level], d, axes=([1], [axis]), precision=precision
    )
    if block_order:
        return jnp.concatenate([G, H], axis=0)
    return _interleave0(G, H)


def split_idct_apply(
    plan: SplitPlan, X: Array, axis: int, precision, level: int = 0,
    block_order: bool = False,
) -> Array:
    """Exact inverse of :func:`split_dct_apply` (same axis convention)."""
    nd = X.ndim
    n = X.shape[axis]
    if level == plan.levels:
        return jnp.tensordot(
            plan.base_inv, X, axes=([1], [axis]), precision=precision
        )
    m = n // 2
    if block_order:
        Xe = X[_sl(nd, axis, slice(0, m))]
        Xo = X[_sl(nd, axis, slice(m, None))]
    else:
        Xe = X[_sl(nd, axis, slice(0, None, 2))]
        Xo = X[_sl(nd, axis, slice(1, None, 2))]
    g = split_idct_apply(plan, Xe, axis, precision, level + 1, block_order)
    dd = jnp.tensordot(
        plan.d4inv[level], Xo, axes=([1], [axis]), precision=precision
    )
    xf = 0.5 * (g + dd)
    xr = 0.5 * (g - dd)
    return jnp.concatenate([xf, jnp.flip(xr, 0)], axis=0)


class DensePlan:
    """Single dense-matmul 'plan' (levels=0 interface of SplitPlan) with
    caller-provided forward/inverse matrices -- used for periodic axes,
    where the transform is the orthonormal circulant eigenbasis."""

    levels = 0

    def __init__(self, fwd: np.ndarray, inv: np.ndarray, dtype):
        self.n = fwd.shape[0]
        self.base_fwd = jnp.asarray(fwd, dtype)
        self.base_inv = jnp.asarray(inv, dtype)


def circulant_eigenbasis(n: int, h: float) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal real eigenbasis Q and eigenvalues of the periodic
    (circulant) 1D second-difference operator on n cells.

    Columns: constant, then (cos, sin) pairs at wavenumbers k = 1..n/2-1,
    then the Nyquist alternating mode (n even). Eigenvalues
    ``lambda_k = -(4/h^2) sin^2(pi k / n)``. Forward transform = Q^T x.
    """
    if n % 2:
        raise ValueError("periodic axis extent must be even")
    j = np.arange(n)
    cols = [np.full(n, 1.0 / np.sqrt(n))]
    lam = [0.0]
    s = np.sqrt(2.0 / n)
    for k in range(1, n // 2):
        lk = -(4.0 / (h * h)) * np.sin(np.pi * k / n) ** 2
        cols.append(s * np.cos(2.0 * np.pi * k * j / n))
        lam.append(lk)
        cols.append(s * np.sin(2.0 * np.pi * k * j / n))
        lam.append(lk)
    cols.append(((-1.0) ** j) / np.sqrt(n))
    lam.append(-(4.0 / (h * h)))
    Q = np.stack(cols, axis=1)
    return Q, np.asarray(lam)


class CircSplitPlan:
    """Symmetric-fold factorization of the circulant eigenbasis transform.

    cos rows of Q^T are symmetric under j -> n-j and sin rows antisymmetric,
    so with g = [x0, x_j + x_{n-j}, x_m] and d = [x_j - x_{n-j}] the forward
    transform is two half-size matmuls (exact 2x MAC reduction, factors
    bounded like the dense basis). Outputs in BLOCK order
    [c0, c1..c_{m-1}, nyquist, s1..s_{m-1}]; :meth:`permutation` maps block
    order back to the natural eigen-column order for the spectral
    multiplier (same zero-relayout trick as the DCT SplitPlan).
    """

    levels = 1  # marker: permuted output order

    def __init__(self, n: int, dtype):
        if n % 2:
            raise ValueError("periodic axis extent must be even")
        m = n // 2
        self.n = n
        j_g = np.arange(m + 1)
        k_c = np.arange(1, m)
        s = np.sqrt(2.0 / n)
        cf = np.empty((m + 1, m + 1))
        cf[0, :] = 1.0 / np.sqrt(n)
        cf[1:m, :] = s * np.cos(2.0 * np.pi * k_c[:, None] * j_g[None, :] / n)
        cf[m, :] = ((-1.0) ** j_g) / np.sqrt(n)
        j_d = np.arange(1, m)
        sf = s * np.sin(2.0 * np.pi * k_c[:, None] * j_d[None, :] / n)
        self.cf = jnp.asarray(cf, dtype)
        self.sf = jnp.asarray(sf, dtype)
        self.cfi = jnp.asarray(np.linalg.inv(cf), dtype)
        self.sfi = jnp.asarray(np.linalg.inv(sf), dtype)

    def permutation(self) -> np.ndarray:
        """block_output[k'] = natural_order[perm[k']] (natural = the
        circulant_eigenbasis column order c0, c1, s1, c2, s2, ..., nyq)."""
        m = self.n // 2
        perm = [0]
        perm += [2 * k - 1 for k in range(1, m)]
        perm += [self.n - 1]
        perm += [2 * k for k in range(1, m)]
        return np.asarray(perm)

    def apply_fwd(self, x: Array, axis: int, precision) -> Array:
        nd = x.ndim
        m = self.n // 2
        x0 = x[_sl(nd, axis, slice(0, 1))]
        xm = x[_sl(nd, axis, slice(m, m + 1))]
        xf = x[_sl(nd, axis, slice(1, m))]
        xr = jnp.flip(x[_sl(nd, axis, slice(m + 1, None))], axis)
        g = jnp.concatenate([x0, xf + xr, xm], axis=axis)
        d = xf - xr
        G = jnp.tensordot(self.cf, g, axes=([1], [axis]), precision=precision)
        D = jnp.tensordot(self.sf, d, axes=([1], [axis]), precision=precision)
        return jnp.concatenate([G, D], axis=0)

    def apply_inv(self, X: Array, axis: int, precision) -> Array:
        nd = X.ndim
        m = self.n // 2
        Xg = X[_sl(nd, axis, slice(0, m + 1))]
        Xd = X[_sl(nd, axis, slice(m + 1, None))]
        g = jnp.tensordot(self.cfi, Xg, axes=([1], [axis]), precision=precision)
        d = jnp.tensordot(self.sfi, Xd, axes=([1], [axis]), precision=precision)
        g0 = g[0:1]
        gm = g[m:m + 1]
        gm_mid = g[1:m]
        xf = 0.5 * (gm_mid + d)
        xr = 0.5 * (gm_mid - d)
        return jnp.concatenate([g0, xf, gm, jnp.flip(xr, 0)], axis=0)


def neumann_eigenvalues(n: int, h: float) -> np.ndarray:
    """Eigenvalues of the 1D cell-centered Neumann Laplacian under DCT-II.

    Our ghost treatment (ghost = edge, ops/poisson.py) gives exactly the
    matrix whose eigenvectors are cos(pi k (2i+1)/(2n)):
      lambda_k = -(4/h^2) sin^2(pi k / (2n)).
    """
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * k / (2 * n)) ** 2


# ---------------------------------------------------------------------------
# Mixed-BC eigenbases. ops/poisson.py discretizes an outflow (pressure-
# Dirichlet) face as ghost = -edge (face value pinned to 0), which is the
# half-sample-odd symmetry; walls/inflow are ghost = edge (half-sample
# even). The cell-centered 1D second-difference operator therefore
# diagonalizes exactly under:
#   even/even  (wall-wall)      -> DCT-II              (neumann_eigenvalues)
#   even/odd   (wall-outflow)   -> DCT-IV              (orthonormal, its own
#                                                       inverse)
#   odd/even   (outflow-wall)   -> index-flipped DCT-IV (same eigenvalues)
#   odd/odd    (outflow-outflow)-> DST-II
# These feed the direct spectral solver (obstacle-free outflow domains are
# now exact in one application) and the DCT-preconditioned CG for obstacle
# topologies (ops/fft_poisson.py).
# ---------------------------------------------------------------------------


def dct4_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-IV: C[k,i] = sqrt(2/n) cos(pi(2k+1)(2i+1)/(4n)).

    Symmetric and orthogonal, so it is exactly its own inverse. Rows are the
    eigenvectors of the Neumann(lo)/Dirichlet(hi) cell-centered Laplacian.
    """
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    return np.sqrt(2.0 / n) * np.cos(
        np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n)
    )


def dst2_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-II: S[k,i] ~ sin(pi(k+1)(2i+1)/(2n)).

    Rows are the eigenvectors of the double-Dirichlet cell-centered
    Laplacian. The last row (k = n-1, the alternating-sign mode) carries
    weight 1/sqrt(n) instead of sqrt(2/n) for orthonormality; inverse is the
    transpose.
    """
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (k + 1) * (2 * i + 1) / (2 * n))
    scale = np.full((n, 1), np.sqrt(2.0 / n))
    scale[n - 1, 0] = np.sqrt(1.0 / n)
    return scale * m


class Dct4SplitPlan:
    """One-level radix split of the (orthonormal) DCT-IV along one axis.

    Exact even-odd butterfly (validated to 1e-14 vs the dense kernel):
    with m = n/2, phi_j = pi(2j+1)/(4n), u_j = x_j, w_j = x_{n-1-j},

        a_j = u_j cos(phi_j) + w_j sin(phi_j)
        b_j = w_j cos(phi_j) - u_j sin(phi_j)          (per-j rotation)
        A[r] = sum_j a_j cos(pi r (2j+1)/(2m))          (DCT-II_m kernel)
        B[r] = sum_j b_j sin(pi r (2j+1)/(2m)), r=1..m  (DST-II_m kernel)
        X[2r] = A[r] + B[r],  X[2r+1] = A[r+1] - B[r+1]  (A[m] == 0)

    Two m x m matmuls instead of one n x n -- an exact 2x MAC
    reduction with all factors bounded by 1 (the rotation is orthogonal),
    so it is as stable as the dense matmul. Outputs in BLOCK order
    [evens; odds]; :meth:`permutation` maps block order back to natural
    for the spectral multiplier (zero-relayout trick shared with
    SplitPlan / CircSplitPlan). The orthonormal scale sqrt(2/n) is folded
    into the rotation factors; the inverse is the exact adjoint (the
    orthonormal DCT-IV is symmetric), so ``apply_inv`` runs the same
    stages transposed.

    ``flipped=True`` implements the Dirichlet-lo/Neumann-hi ('dn') axis:
    the basis is the index-reversed DCT-IV, so the forward flips its
    input and the inverse flips its output.
    """

    levels = 1  # marker: permuted (block-order) output

    def __init__(self, n: int, dtype, flipped: bool = False):
        if n % 2:
            raise ValueError("DCT-IV split needs an even extent")
        m = n // 2
        self.n = n
        self.flipped = flipped
        phi = np.pi * (2 * np.arange(m) + 1) / (4 * n)
        s = np.sqrt(2.0 / n)
        self.cos = jnp.asarray(s * np.cos(phi), dtype)
        self.sin = jnp.asarray(s * np.sin(phi), dtype)
        r = np.arange(m)[:, None]
        j = np.arange(m)[None, :]
        self.c2 = jnp.asarray(np.cos(np.pi * r * (2 * j + 1) / (2 * m)), dtype)
        self.dst = jnp.asarray(
            np.sin(np.pi * (r + 1) * (2 * j + 1) / (2 * m)), dtype
        )

    def permutation(self) -> np.ndarray:
        m = self.n // 2
        return np.concatenate([2 * np.arange(m), 2 * np.arange(m) + 1])

    def _vec(self, v: Array, nd: int, axis: int) -> Array:
        shape = [1] * nd
        shape[axis] = v.shape[0]
        return v.reshape(shape)

    def apply_fwd(self, x: Array, axis: int, precision) -> Array:
        nd = x.ndim
        m = self.n // 2
        if self.flipped:
            x = jnp.flip(x, axis)
        u = x[_sl(nd, axis, slice(0, m))]
        w = jnp.flip(x[_sl(nd, axis, slice(m, None))], axis)
        c = self._vec(self.cos, nd, axis)
        s = self._vec(self.sin, nd, axis)
        a = c * u + s * w
        b = c * w - s * u
        A = jnp.tensordot(self.c2, a, axes=([1], [axis]), precision=precision)
        B = jnp.tensordot(self.dst, b, axes=([1], [axis]), precision=precision)
        zero = jnp.zeros_like(A[0:1])
        E = A + jnp.concatenate([zero, B[:-1]], axis=0)
        O = jnp.concatenate([A[1:], zero], axis=0) - B
        return jnp.concatenate([E, O], axis=0)

    def apply_inv(self, X: Array, axis: int, precision) -> Array:
        nd = X.ndim
        m = self.n // 2
        E = X[_sl(nd, axis, slice(0, m))]
        O = X[_sl(nd, axis, slice(m, None))]
        e0 = E[_sl(nd, axis, slice(0, 1))]
        et = E[_sl(nd, axis, slice(1, None))]
        oh = O[_sl(nd, axis, slice(0, m - 1))]
        ol = O[_sl(nd, axis, slice(m - 1, None))]
        At = jnp.concatenate([e0, et + oh], axis=axis)
        Bt = jnp.concatenate([et - oh, -ol], axis=axis)
        a = jnp.tensordot(self.c2.T, At, axes=([1], [axis]), precision=precision)
        b = jnp.tensordot(self.dst.T, Bt, axes=([1], [axis]), precision=precision)
        c = self._vec(self.cos, nd, 0)
        s = self._vec(self.sin, nd, 0)
        u = c * a - s * b
        w = s * a + c * b
        x = jnp.concatenate([u, jnp.flip(w, 0)], axis=0)
        if self.flipped:
            x = jnp.flip(x, 0)
        return x


def mixed_nd_eigenvalues(n: int, h: float) -> np.ndarray:
    """Neumann(lo)/Dirichlet(hi) eigenvalues (DCT-IV basis):
    lambda_k = -(4/h^2) sin^2(pi (2k+1) / (4n)). Strictly negative -- a
    Dirichlet face removes the constant nullspace."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * (2 * k + 1) / (4 * n)) ** 2


def dirichlet_eigenvalues(n: int, h: float) -> np.ndarray:
    """Double-Dirichlet eigenvalues (DST-II basis):
    lambda_k = -(4/h^2) sin^2(pi (k+1) / (2n))."""
    k = np.arange(n)
    return -(4.0 / (h * h)) * np.sin(np.pi * (k + 1) / (2 * n)) ** 2
