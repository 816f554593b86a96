"""FFT helpers and FFT-domain filtering.

Equivalents of the reference's unified DFT wrapper
(``framework/modules/saf_utilities/saf_utility_fft.h``): the backend axis
(FFTW/IPP/vDSP/MKL/kissFFT) collapses to XLA's native FFT; the conventions
are kept identical — unnormalised forward transform, 1/N-scaled inverse
(``saf_utility_fft.c:541``).

All functions are pure and jit-friendly; batch dims lead.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# DFT implementation selection: 'fft' is XLA's FFT op, 'matmul' a dense
# DFT-as-matmul (kept as a reference the tests compare against).  'auto'
# resolves to 'fft' on every backend this program runs on.
# ---------------------------------------------------------------------------

_DFT_IMPL = contextvars.ContextVar("saf_dft_impl", default="auto")


def _resolve_impl() -> str:
    impl = _DFT_IMPL.get()
    return "fft" if impl == "auto" else impl


@contextlib.contextmanager
def force_dft_impl(impl: str):
    """Override DFT implementation ('fft' | 'matmul' | 'auto') while tracing."""
    tok = _DFT_IMPL.set(impl)
    try:
        yield
    finally:
        _DFT_IMPL.reset(tok)


@functools.lru_cache(maxsize=None)
def _rdft_mats(n: int):
    """Real-DFT matmul operators for length n (numpy, float32).

    forward:  rfft(x)  = x @ C + 1j·(x @ S)           C,S: (n, n//2+1)
    backward: irfft(X) = X.re @ A + X.im @ B          A,B: (n//2+1, n)
    Matches numpy/XLA conventions (unnormalised forward, 1/n inverse; the
    imaginary parts of the DC/Nyquist bins do not contribute).
    """
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(t, k) / n  # (n, k)
    C = np.cos(ang)
    S = -np.sin(ang)
    c = np.where((k == 0) | (k == n // 2), 1.0, 2.0)
    A = (c[:, None] * np.cos(ang).T) / n
    B = (-c[:, None] * np.sin(ang).T) / n
    return (C.astype(np.float32), S.astype(np.float32),
            A.astype(np.float32), B.astype(np.float32))


def rfft_op(x, n: int, precision=None):
    """Forward real DFT of the last axis (length n), backend-adaptive.

    ``precision`` applies to the matmul-DFT backend only; None = exact f32
    (HIGHEST — design-time callers must keep full accuracy; a reduced-
    precision pass would blow the ≤1e-4 parity budget).  The complex
    per-block process paths (ops/matrix_conv.py apply/apply_block) pass
    ``precision.HOT`` (see ops/precision.py), matching the RI fast paths.
    """
    if x.shape[-1] != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    if _resolve_impl() == "fft":
        return jnp.fft.rfft(x, n=n, axis=-1)
    C, S, _, _ = _rdft_mats(n)
    hp = precision or jax.lax.Precision.HIGHEST
    return jax.lax.complex(jnp.matmul(x, jnp.asarray(C), precision=hp),
                           jnp.matmul(x, jnp.asarray(S), precision=hp))


def irfft_op(X, n: int, precision=None):
    """Inverse real DFT (1/n-scaled) of the last axis, backend-adaptive.

    The imaginary parts of the DC and (even n) Nyquist bins do not
    contribute, as in the reference's saf_rfft and numpy.  They are zeroed
    before XLA's FFT because the GPU's C2R transform does not ignore them
    for every batch size (PERF.md)."""
    if _resolve_impl() == "fft":
        edge = np.zeros(X.shape[-1], bool)
        edge[0] = True
        edge[-1] |= n % 2 == 0
        X = jnp.where(edge, jnp.real(X).astype(X.dtype), X)
        return jnp.fft.irfft(X, n=n, axis=-1)
    _, _, A, B = _rdft_mats(n)
    hp = precision or jax.lax.Precision.HIGHEST
    return (jnp.matmul(jnp.real(X), jnp.asarray(A), precision=hp)
            + jnp.matmul(jnp.imag(X), jnp.asarray(B), precision=hp))


def rfft_op_ri(x, n: int, precision=None):
    """rfft_op returning an (re, im) float pair — for complex-free device
    paths (some runtimes poison d2h readback after any complex64)."""
    if x.shape[-1] != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    C, S, _, _ = _rdft_mats(n)
    hp = precision or jax.lax.Precision.HIGHEST
    return (jnp.matmul(x, jnp.asarray(C), precision=hp),
            jnp.matmul(x, jnp.asarray(S), precision=hp))


def irfft_op_ri(Xre, Xim, n: int, precision=None):
    """irfft_op on an (re, im) float pair (1/n-scaled)."""
    _, _, A, B = _rdft_mats(n)
    hp = precision or jax.lax.Precision.HIGHEST
    return (jnp.matmul(Xre, jnp.asarray(A), precision=hp)
            + jnp.matmul(Xim, jnp.asarray(B), precision=hp))


def get_uniform_freq_vector(fft_size: int, fs: float) -> np.ndarray:
    """Centre frequencies of rFFT bins (saf_utility_fft.h:67)."""
    return np.arange(fft_size // 2 + 1, dtype=np.float64) * fs / float(fft_size)


def rfft(x, n: int | None = None):
    """Real→complex forward FFT, unnormalised (saf_rfft_forward)."""
    return jnp.fft.rfft(x, n=n, axis=-1)


def irfft(X, n: int):
    """Complex→real inverse FFT with 1/N scaling (saf_rfft_backward)."""
    return jnp.fft.irfft(X, n=n, axis=-1)


def fft(x, n: int | None = None):
    """Complex forward FFT (saf_fft_forward)."""
    return jnp.fft.fft(x, n=n, axis=-1)


def ifft(X, n: int | None = None):
    """Complex inverse FFT, 1/N scaled (saf_fft_backward)."""
    return jnp.fft.ifft(X, n=n, axis=-1)


def fftconv(x, h, out_len: int | None = None):
    """Linear convolution via FFT (saf_utility_fft.h:86 ``fftconv``).

    x: (..., x_len), h: (..., h_len) → (..., x_len + h_len - 1) or out_len.
    """
    x_len = x.shape[-1]
    h_len = h.shape[-1]
    full = x_len + h_len - 1
    nfft = int(2 ** np.ceil(np.log2(full)))
    y = jnp.fft.irfft(jnp.fft.rfft(x, n=nfft) * jnp.fft.rfft(h, n=nfft), n=nfft)
    y = y[..., :full]
    if out_len is not None:
        y = y[..., :out_len]
    return y


def fftfilt(x, h):
    """'filter'-style convolution: same length as x (saf_utility_fft.h:107)."""
    return fftconv(x, h)[..., : x.shape[-1]]


def hilbert(x):
    """Analytic signal via FFT (saf_utility_fft.h:128 ``hilbert``)."""
    n = x.shape[-1]
    X = jnp.fft.fft(x, axis=-1)
    w = np.zeros(n)
    if n % 2 == 0:
        w[0] = w[n // 2] = 1.0
        w[1 : n // 2] = 2.0
    else:
        w[0] = 1.0
        w[1 : (n + 1) // 2] = 2.0
    return jnp.fft.ifft(X * jnp.asarray(w, dtype=X.dtype), axis=-1)
