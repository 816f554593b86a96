"""IIR filtering as a parallel linear recurrence.

The reference applies IIRs sample-by-sample (saf_utility_filters.c
``applyIIR``, direct-form-II).  A sequential per-sample loop is the worst
case for a wide accelerator, but an order-d IIR is a *linear* recurrence
s_t = A s_{t-1} + B x_t, which evaluates in O(log T) depth with
``lax.associative_scan`` over affine maps.

``iir_filter`` matches scipy.signal.lfilter (direct-form-II-transposed
semantics) including initial/final conditions, batched over leading axes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _affine_scan(A: jax.Array, bvec: jax.Array):
    """Cumulative composition of affine maps s_t = A s_{t-1} + b_t.

    A: (..., d, d) broadcastable against bvec's batch dims; bvec: (T, ..., d).
    Returns s: (T, ..., d) with s_0 = A·0 + b_0 (fold any initial state into
    b_0)."""
    T = bvec.shape[0]
    As = jnp.broadcast_to(A, (T,) + bvec.shape[1:] + (A.shape[-1],))

    # The affine compositions MUST run in full f32: reduced-precision
    # matmul inputs (bf16 or TF32), and repeated composition of near-unit-circle pole
    # matrices (e.g. a 100 Hz HPF at 48 kHz) then overflows to NaN.
    hp = jax.lax.Precision.HIGHEST

    def combine(l, r):
        Al, bl = l
        Ar, br = r
        return (jnp.matmul(Ar, Al, precision=hp),
                jnp.einsum("t...ij,t...j->t...i", Ar, bl, precision=hp) + br)

    _, s = jax.lax.associative_scan(combine, (As, bvec))
    return s


def _df2t_matrices(b: np.ndarray, a: np.ndarray):
    """Build the DF2T state matrices for (batched) coefficient arrays.

    b, a: (..., n) host arrays (a[...,0] normalised away).
    Returns (A (..., d, d), Bx (..., d), b0 (...,))."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = b / a[..., :1]
    a = a / a[..., :1]
    d = a.shape[-1] - 1
    batch = a.shape[:-1]
    A = np.zeros(batch + (d, d))
    for i in range(d - 1):
        A[..., i, i + 1] = 1.0
    A[..., :, 0] -= a[..., 1:]
    Bx = b[..., 1:] - a[..., 1:] * b[..., :1]
    return A, Bx, b[..., 0]


def iir_filter_batched(b: np.ndarray, a: np.ndarray, x, zi=None):
    """Batched-coefficient IIR along the last axis.

    b, a: (..., n) host numpy (one filter per batch element, broadcastable
    against x's leading dims); x: (..., T).  Returns (y, zf) with zf shaped
    (..., n-1).  Same DF2T semantics as scipy lfilter.
    """
    A, Bx, b0 = _df2t_matrices(b, a)
    dtype = x.dtype
    A_ = jnp.asarray(A, dtype)
    Bx_ = jnp.asarray(Bx, dtype)
    b0_ = jnp.asarray(b0, dtype)
    xt = jnp.moveaxis(x, -1, 0)  # (T, ...)
    bvec = xt[..., None] * Bx_
    if zi is not None:
        bvec = bvec.at[0].add(jnp.einsum("...ij,...j->...i", A_, zi))
    s = _affine_scan(A_, bvec)
    first = (zi[..., 0] if zi is not None else jnp.zeros_like(s[0, ..., 0]))
    s_prev0 = jnp.concatenate([first[None], s[:-1, ..., 0]], axis=0)
    y = b0_ * xt + s_prev0
    return jnp.moveaxis(y, 0, -1), s[-1]


def iir_filter(b, a, x, zi=None):
    """Apply an IIR filter along the last axis (scipy lfilter DF2T semantics).

    b, a: (n,) host arrays (a[0]==1); x: (..., T); zi: (..., n-1) or None.
    Returns (y, zf).
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b = (b / a[0])
    a = (a / a[0])
    d = len(a) - 1
    assert d >= 1
    # DF2T state recurrence: z_i[t] = b[i+1]x[t] - a[i+1]y[t] + z_{i+1}[t-1],
    # y[t] = b[0]x[t] + z_0[t-1].  Write s_t = A s_{t-1} + B x_t with
    # s = (z_0..z_{d-1}):  y_t = b0 x_t + s0_{t-1}
    # z_i[t] = z_{i+1}[t-1] - a[i+1](b0 x_t + s0_{t-1}) + b[i+1] x_t
    A = np.zeros((d, d))
    for i in range(d - 1):
        A[i, i + 1] = 1.0
    A[:, 0] -= a[1:]
    Bx = (b[1:] - a[1:] * b[0])  # (d,)
    dtype = x.dtype
    A_ = jnp.asarray(A, dtype)
    Bx_ = jnp.asarray(Bx, dtype)

    xt = jnp.moveaxis(x, -1, 0)  # (T, ...)
    bvec = xt[..., None] * Bx_  # (T, ..., d)
    if zi is not None:
        bvec = bvec.at[0].add(jnp.einsum("ij,...j->...i", A_, zi))
    s = _affine_scan(A_, bvec)  # (T, ..., d) = state AFTER sample t
    s_prev0 = jnp.concatenate(
        [jnp.zeros_like(s[:1, ..., 0]) if zi is None else
         zi[..., 0][None], s[:-1, ..., 0]], axis=0)
    y = jnp.asarray(b[0], dtype) * xt + s_prev0
    y = jnp.moveaxis(y, 0, -1)
    zf = jnp.moveaxis(s[-1], -1, 0)  # (d, ...)
    return y, jnp.moveaxis(zf, 0, -1)


# ---------------------------------------------------------------------------
# Exact block form: y = H x + Z zi,  s_T = Kx x + AT zi
# ---------------------------------------------------------------------------

_BLOCK_MATS_CACHE: dict = {}


def _iir_block_mats(b: np.ndarray, a: np.ndarray, T: int):
    """Design-time unroll of the DF2T recurrence over a fixed block length:

        y[t]  = b0·x[t] + e0ᵀ A^t·zi + Σ_{k<t} (e0ᵀ A^{t-1-k} Bx)·x[k]
        s_T   = A^T·zi + Σ_k A^{T-1-k} Bx·x[k]

    → (H (..., T, T) lower-triangular Toeplitz of the impulse response,
       Z (..., T, d), Kx (..., d, T), AT (..., d, d)), float32.

    This replaces the associative scan of (d × d) companion products —
    O(T·d³) FLOPs in badly-padded tiny matmuls for the order-20 lattice
    decorrelators — with four dense matmuls.  Exact for any h decay
    (the state terms carry whatever the T-tap window does not)."""
    key = (b.tobytes(), a.tobytes(), b.shape, a.shape, T)
    hit = _BLOCK_MATS_CACHE.get(key)
    if hit is not None:
        return hit
    A, Bx, b0 = _df2t_matrices(b, a)
    batch = A.shape[:-2]
    d = A.shape[-1]
    # powers of A (f64)
    P = np.zeros((T + 1,) + batch + (d, d))
    P[0] = np.broadcast_to(np.eye(d), batch + (d, d))
    for t in range(1, T + 1):
        P[t] = P[t - 1] @ A
    # impulse response: h[0] = b0; h[j] = e0ᵀ A^{j-1} Bx
    g = np.einsum("t...ij,...j->t...i", P[:T], Bx)[..., 0]   # (T, ...)
    h = np.concatenate([b0[None], g[:-1]], axis=0)           # (T, ...)
    hm = np.moveaxis(h, 0, -1)                                # (..., T)
    H = np.zeros(batch + (T, T))
    for j in range(T):
        ii = np.arange(j, T)
        H[..., ii, ii - j] = hm[..., j:j + 1]
    Z = np.moveaxis(P[:T][..., 0, :], 0, -2)                  # (..., T, d)
    Kx = np.moveaxis(np.einsum("t...ij,...j->t...i", P[T - 1::-1], Bx),
                     0, -1)                                   # (..., d, T)
    AT = P[T]
    out = tuple(np.asarray(m, np.float32) for m in (H, Z, Kx, AT))
    _BLOCK_MATS_CACHE[key] = out
    return out


_ONEPOLE_CACHE: dict = {}


def onepole_ewma_mats(lam: float, n: int):
    """The one-pole EWMA y[t] = lam·y[t-1] + (1-lam)·u[t] over a length-n
    block in exact block form: y = L @ u + p·y0 with
    L[t,k] = (1-lam)·lam^(t-k) (lower triangular) and p[t] = lam^(t+1).
    Replaces a length-n lax.scan with one (n×n) matmul — the cross-block
    recurrence pattern shared by the HADES and spreader chunk paths.
    Returns float32 (L, p) as jnp arrays."""
    key = (float(lam), int(n))
    if key not in _ONEPOLE_CACHE:
        t = np.arange(n)
        L = (1.0 - lam) * np.power(float(lam), np.maximum(
            t[:, None] - t[None, :], 0.0))
        L *= (t[:, None] >= t[None, :])
        _ONEPOLE_CACHE[key] = (np.asarray(L, np.float32),
                               np.asarray(np.power(float(lam), t + 1.0),
                                          np.float32))
    L, p = _ONEPOLE_CACHE[key]
    return jnp.asarray(L), jnp.asarray(p)


def iir_filter_batched_block(b: np.ndarray, a: np.ndarray, x, zi):
    """iir_filter_batched semantics via the exact block form (fixed
    T = x.shape[-1]).  b, a: (..., n) host numpy; x: (..., batch..., T)
    broadcastable against the coefficient batch; zi: (..., n-1)."""
    T = x.shape[-1]
    H, Z, Kx, AT = _iir_block_mats(np.asarray(b), np.asarray(a), T)
    hp = jax.lax.Precision.HIGHEST
    Hj, Zj, Kxj, ATj = (jnp.asarray(m) for m in (H, Z, Kx, AT))
    y = (jnp.einsum("...ts,...s->...t", Hj, x, precision=hp)
         + jnp.einsum("...td,...d->...t", Zj, zi, precision=hp))
    zf = (jnp.einsum("...dt,...t->...d", Kxj, x, precision=hp)
          + jnp.einsum("...de,...e->...d", ATj, zi, precision=hp))
    return y, zf
