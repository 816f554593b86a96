"""Linear-algebra kernel layer (counterpart of ``saf_utility_veclib``).

The reference's 114 ``utility_?xxx`` functions wrap CBLAS/LAPACK per dtype
prefix (s/c/d/z).  Here the backend axis collapses to NumPy (host design
work, float64) and jnp (device, batched) — both dispatch through the same
functions, and every op accepts leading batch dimensions, which is the
replacement for the reference's per-call workspace handles.

Naming maps 1:1 (minus the dtype prefix): e.g. ``utility_ssvd``/``csvd`` →
``svd``; ``utility_cglslv`` → ``glslv``; ``utility_spinv`` → ``pinv``.
"""
from __future__ import annotations

import numpy as np


def _xp(*arrays):
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


# -- index of min/max (utility_siminv/simaxv and friends) --------------------

def _cabs1(x, xp):
    """BLAS's complex 'absolute value' |Re|+|Im| (cabs1), used by
    icamin/icamax — NOT the modulus; real inputs are |x|."""
    if xp.iscomplexobj(x):
        return xp.abs(xp.real(x)) + xp.abs(xp.imag(x))
    return xp.abs(x)


def iminv(x):
    """Index of the element with the minimum absolute value (utility_?iminv).
    Complex inputs compare by cabs1 = |Re|+|Im| as cblas_icamin does."""
    xp = _xp(x)
    return xp.argmin(_cabs1(x, xp), axis=-1)


def imaxv(x):
    """Index of the element with the maximum absolute value (utility_?imaxv).
    Complex inputs compare by cabs1 = |Re|+|Im| as cblas_icamax does."""
    xp = _xp(x)
    return xp.argmax(_cabs1(x, xp), axis=-1)


# -- elementwise (utility_?vabs/vmod/vrecip/vconj/vvcopy/vvadd/...) ----------

def vvdot(a, b, conj: bool = False):
    """Dot product (utility_?vvdot; conj=CONJ/NO_CONJ flag)."""
    xp = _xp(a, b)
    return xp.sum((xp.conj(a) if conj else a) * b, axis=-1)


# -- decompositions ----------------------------------------------------------

def svd(A, full_matrices: bool = True):
    """SVD returning (U, S, V) with V NOT transposed — MATLAB convention,
    matching utility_?svd."""
    xp = _xp(A)
    U, s, Vh = xp.linalg.svd(A, full_matrices=full_matrices)
    return U, s, xp.conj(xp.swapaxes(Vh, -1, -2))


def seig(A, sort_decreasing: bool = True):
    """Symmetric/Hermitian EVD (utility_?seig): returns (V, D) with columns
    sorted by decreasing eigenvalue when sort_decreasing."""
    xp = _xp(A)
    d, V = xp.linalg.eigh(A)
    if sort_decreasing:
        d = d[..., ::-1]
        V = V[..., ::-1]
    return V, d


def eig(A):
    """General EVD (utility_?eig) → (eigenvalues, right eigenvectors)."""
    return np.linalg.eig(np.asarray(A))


def eigmp(A, B):
    """Generalised EVD A·V = B·V·D (utility_?eigmp) — host SciPy."""
    from scipy.linalg import eig as geig

    d, V = geig(np.asarray(A), np.asarray(B))
    return d, V


# -- solvers -------------------------------------------------------------------

def glslv(A, B):
    """General linear solve A·X = B (utility_?glslv)."""
    xp = _xp(A, B)
    return xp.linalg.solve(A, B)


def glslvt(A, B):
    """Transposed solve X·A = B (utility_sglslvt)."""
    xp = _xp(A, B)
    return xp.swapaxes(xp.linalg.solve(xp.swapaxes(A, -1, -2),
                                       xp.swapaxes(B, -1, -2)), -1, -2)


def slslv(A, B):
    """Symmetric-positive-definite solve (utility_?slslv; LAPACK posv)."""
    xp = _xp(A, B)
    if xp is np:
        from scipy.linalg import solve

        return solve(np.asarray(A), np.asarray(B), assume_a="pos")
    import jax.scipy.linalg as jsl

    c = jsl.cho_factor(A)
    return jsl.cho_solve(c, B)


def pinv(A, rcond: float = 1e-15):
    """Moore-Penrose pseudo-inverse (utility_?pinv)."""
    return _xp(A).linalg.pinv(A, rcond=rcond)


def chol(A):
    """Cholesky, MATLAB convention X s.t. Xᴴ X = A (utility_?chol)."""
    xp = _xp(A)
    L = xp.linalg.cholesky(A)
    return xp.conj(xp.swapaxes(L, -1, -2))


def det(A):
    """Determinant (utility_?det)."""
    return _xp(A).linalg.det(A)


def inv(A):
    """Matrix inverse (utility_?inv)."""
    return _xp(A).linalg.inv(A)


# -- elementwise vector ops (utility_?vabs/vmod/vrecip/vconj/vvcopy/vvadd/
#    vvsub/vvmul/svsmul/svsdiv/svsadd/svssub; saf_utility_veclib.h:150-860).
#    Kept for API parity — under jit XLA fuses these anyway.

def vabs(x):
    return _xp(x).abs(x)


def vmod(a, b):
    """Elementwise modulus a % b (utility_?vmod)."""
    return _xp(a, b).mod(a, b)


def vrecip(x):
    return 1.0 / x


def vconj(x):
    return _xp(x).conj(x)


def vneg(x):
    return -x


def vvcopy(x):
    xp = _xp(x)
    return xp.array(x, copy=True) if xp is np else xp.asarray(x).copy()


def vvadd(a, b):
    return a + b


def vvsub(a, b):
    return a - b


def vvmul(a, b):
    return a * b


def svsmul(x, s):
    """Vector × scalar (utility_?svsmul)."""
    return x * s


def svsdiv(x, s):
    return x / s


def svsadd(x, s):
    return x + s


def svssub(x, s):
    return x - s


def vsadd(x, s):
    """In the reference vsadd == svsadd with accumulate variants; alias."""
    return x + s


def sv2cv_inds(sv, inds):
    """Gather: cv[i] = sv[inds[i]] (utility_ssv2cv_inds; the MKL path uses
    cblas_sgthr, the portable path an unrolled copy loop)."""
    xp = _xp(sv)
    return xp.take(sv, inds, axis=-1)
