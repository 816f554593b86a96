"""Complex linear algebra in split real/imaginary arithmetic.

Every analyser (powermap, sldoa, dirass, spreader, hades, pitch_shifter)
runs its covariance / subspace math here in real arithmetic, so no complex
dtype reaches the device graph: a complex matrix C = A + iB is a
pair ``(A, B)`` of real arrays, and a Hermitian C embeds isomorphically as
the real-symmetric ``[[A, -B], [B, A]]`` (A symmetric, B antisymmetric).
Solves and eigendecompositions of the embedding are real ops XLA runs
natively on any backend; each complex eigenpair of C appears twice in the
embedding with the same eigenvalue, so subspace projectors need no
de-duplication — a complex d-dim subspace is exactly a real 2d-dim one.

Counterpart of the complex half of the reference's veclib
(saf_utility_veclib.h: utility_cseig/cpinv/cglslv/…) for the on-device
paths; shapes are (..., n, n) batched throughout.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Cmplx = Tuple[jax.Array, jax.Array]  # (real, imag), same shapes


# ---------------------------------------------------------------------------
# elementwise complex arithmetic on (re, im) pairs
# ---------------------------------------------------------------------------

def cmul(a: Cmplx, b: Cmplx) -> Cmplx:
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def conj(a: Cmplx) -> Cmplx:
    return a[0], -a[1]


def cabs2(a: Cmplx) -> jax.Array:
    return a[0] * a[0] + a[1] * a[1]


def cdiv(a: Cmplx, b: Cmplx, eps: float = 0.0) -> Cmplx:
    d = cabs2(b) + eps
    return ((a[0] * b[0] + a[1] * b[1]) / d,
            (a[1] * b[0] - a[0] * b[1]) / d)


def cmatmul(a: Cmplx, b: Cmplx) -> Cmplx:
    """(..., m, k) @ (..., k, n) complex matmul as four real matmuls."""
    return (a[0] @ b[0] - a[1] @ b[1], a[0] @ b[1] + a[1] @ b[0])


def ceinsum(subscripts: str, a: Cmplx, b: Cmplx, **kw) -> Cmplx:
    e = jnp.einsum
    return (e(subscripts, a[0], b[0], **kw) - e(subscripts, a[1], b[1], **kw),
            e(subscripts, a[0], b[1], **kw) + e(subscripts, a[1], b[0], **kw))


# ---------------------------------------------------------------------------
# Hermitian embedding
# ---------------------------------------------------------------------------

def herm_embed(C: Cmplx) -> jax.Array:
    """Hermitian (..., n, n) → real-symmetric (..., 2n, 2n)
    [[A, -B], [B, A]]."""
    A, B = C
    top = jnp.concatenate([A, -B], axis=-1)
    bot = jnp.concatenate([B, A], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def embed_general(A: Cmplx) -> jax.Array:
    """Any complex (..., m, n) → real (..., 2m, 2n) [[Ar, -Ai], [Ai, Ar]].
    The embedding is a ring homomorphism: matmul/SVD/elementwise-real ops on
    embeddings correspond exactly to the complex ops."""
    Ar, Ai = A
    top = jnp.concatenate([Ar, -Ai], axis=-1)
    bot = jnp.concatenate([Ai, Ar], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def extract_embedded(E: jax.Array, m: int, n: int) -> Cmplx:
    """Inverse of embed_general, averaging the two redundant blocks so f32
    noise that breaks exact embedding structure is symmetrised away."""
    re = 0.5 * (E[..., :m, :n] + E[..., m:, n:])
    im = 0.5 * (E[..., m:, :n] - E[..., :m, n:])
    return re, im


def herm_eig_pairs(C: Cmplx):
    """Eigendecomposition of Hermitian C via the embedding: returns
    (λ (..., n) ascending, V (..., n, n) complex pair).  Column k of the
    embedded eigenbasis at even index maps to the complex eigenvector up to
    a phase (irrelevant for square roots / projectors / subspaces)."""
    n = C[0].shape[-1]
    w, V = herm_eigh_embedded(C)
    lam = w[..., ::2]
    return lam, (V[..., :n, ::2], V[..., n:, ::2])


def rayleigh_refine(C: Cmplx, V: Cmplx) -> jax.Array:
    """One Rayleigh-quotient pass: λ_k = Re(v_kᴴ C v_k) / v_kᴴ v_k per
    eigenvector column of V (..., n, k) → (..., k).

    XLA's f32 Jacobi eigh leaves eigenvector error ~ε/gap; the Rayleigh
    quotient is stationary at eigenvectors, so its eigenvalue error is
    O(vector error²) — a cheap (three batched matmuls) way to pull f32
    eigenvalues toward f64 accuracy for downstream eigenvalue-only consumers
    (COMEDIE diffuseness in saf_hades_analysis.c:244-357 parity)."""
    CV = cmatmul(C, V)
    num = (V[0] * CV[0] + V[1] * CV[1]).sum(axis=-2)
    den = (V[0] * V[0] + V[1] * V[1]).sum(axis=-2)
    return num / den


def herm_solve(C: Cmplx, B: Cmplx) -> Cmplx:
    """Solve C X = B for Hermitian C; B: (..., n, k) complex pair.

    n == 2 takes a closed form (Cramer): det = c00·c11 − |c01|² is real for
    Hermitian C, so the whole solve is elementwise — no batched LU.  The
    generic path lowers to jnp.linalg.solve on the real embedding, a
    pivoted LU over thousands of tiny matrices."""
    n = B[0].shape[-2]
    if n == 2:
        c00 = C[0][..., 0, 0, None]          # real (Hermitian diagonal)
        c11 = C[0][..., 1, 1, None]
        r01 = C[0][..., 0, 1, None]
        i01 = C[1][..., 0, 1, None]
        det = c00 * c11 - (r01 * r01 + i01 * i01)
        b0 = (B[0][..., 0, :], B[1][..., 0, :])
        b1 = (B[0][..., 1, :], B[1][..., 1, :])
        # x0 = (c11·b0 − c01·b1)/det ; x1 = (c00·b1 − conj(c01)·b0)/det
        x0 = ((c11 * b0[0] - (r01 * b1[0] - i01 * b1[1])) / det,
              (c11 * b0[1] - (r01 * b1[1] + i01 * b1[0])) / det)
        x1 = ((c00 * b1[0] - (r01 * b0[0] + i01 * b0[1])) / det,
              (c00 * b1[1] - (r01 * b0[1] - i01 * b0[0])) / det)
        return (jnp.stack([x0[0], x1[0]], axis=-2),
                jnp.stack([x0[1], x1[1]], axis=-2))
    M = herm_embed(C)
    rhs = jnp.concatenate([B[0], B[1]], axis=-2)
    X = jnp.linalg.solve(M, rhs)
    return X[..., :n, :], X[..., n:, :]


def herm_inv(C: Cmplx) -> Cmplx:
    n = C[0].shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=C[0].dtype),
                           C[0].shape[:-2] + (n, n))
    return herm_solve(C, (eye, jnp.zeros_like(eye)))


def herm_eigh_embedded(C: Cmplx):
    """eigh of the real embedding: (w, V) with w (..., 2n) ascending and V
    (..., 2n, 2n) real.  Eigenvalues of C each appear twice (adjacent after
    sorting); columns 2k/2k+1 span the embedded complex eigvector ray."""
    return jnp.linalg.eigh(herm_embed(C))


def noise_projector(C: Cmplx, n_sources: int) -> Cmplx:
    """Projector onto the noise subspace (the n - n_sources smallest
    eigenvalues) of Hermitian C, returned as a complex (re, im) pair.

    P_emb = V_n V_nᵀ over the 2(n-K) smallest embedded eigenvectors equals
    the embedding [[Re P, -Im P], [Im P, Re P]] of the complex projector.
    """
    n = C[0].shape[-1]
    w, V = herm_eigh_embedded(C)
    k2 = 2 * (n - n_sources)
    Vn = V[..., :k2]  # ascending order → smallest first
    P = Vn @ jnp.swapaxes(Vn, -1, -2)  # (..., 2n, 2n)
    return P[..., :n, :n], P[..., n:, :n]  # (Re P, Im P)


def signal_subspace_quadform(C: Cmplx, n_sources: int, Y: jax.Array):
    """‖V_nᵀ [Y; 0]‖² per steering column for REAL steering Y (n, g):
    the MUSIC denominator yᴴ P_n y without forming the projector."""
    n = C[0].shape[-1]
    _, V = herm_eigh_embedded(C)
    k2 = 2 * (n - n_sources)
    Vn = V[..., :k2]                       # (..., 2n, 2(n-K))
    # [y; 0] only hits the top row-block of Vnᵀ
    VnY = jnp.einsum("...sk,sg->...kg", Vn[..., :n, :], Y)
    return jnp.sum(VnY ** 2, axis=-2)


def herm_quadform_real(C: Cmplx, Y: jax.Array) -> jax.Array:
    """real(yᵀ C y) per column of REAL Y (n, g): only Re C contributes
    (Im C is antisymmetric)."""
    return jnp.einsum("sg,...st,tg->...g", Y, C[0], Y)


def herm_quadform(C: Cmplx, W: Cmplx) -> jax.Array:
    """real(wᴴ C w) per column of complex W (..., n, g), Hermitian C."""
    A, B = C
    u, v = W

    def t(M, x, y):
        return jnp.einsum("...sg,...st,...tg->...g", x, M, y)

    return t(A, u, u) + t(A, v, v) - t(B, u, v) + t(B, v, u)


def quadform_trans(C: Cmplx, W: Cmplx) -> jax.Array:
    """real(wᵀ C w) — NO conjugate on the first factor, matching the
    reference's generatePWDmap NO_CONJ dot (saf_sh.c:1563-1578), which the
    MVDR/CroPaC maps inherit when fed complex beamforming weights."""
    A, B = C
    u, v = W

    def t(M, x, y):
        return jnp.einsum("...sg,...st,...tg->...g", x, M, y)

    return t(A, u, u) - t(A, v, v) - t(B, u, v) - t(B, v, u)


def split(x) -> Cmplx:
    """numpy/jnp complex array → (re, im) float pair (host-side helper)."""
    import numpy as np

    x = np.asarray(x)
    return (jnp.asarray(x.real.astype(np.float32)),
            jnp.asarray(x.imag.astype(np.float32)))


def join(x: Cmplx):
    """(re, im) pair → host numpy complex (d2h happens on the REAL parts,
    so this is safe on runtimes that poison complex readback)."""
    import numpy as np

    return np.asarray(x[0]) + 1j * np.asarray(x[1])


def cheev_2x2(C: Cmplx):
    """LAPACK-``cheev``-convention eigendecomposition of Hermitian 2×2
    batches — closed form, branchless, bit-matching the reference's
    ``utility_cseig`` (OpenBLAS cheev) including eigenvector SIGNS:

    * chetrd/clarfg: the off-diagonal is made real as
      e = −sign(Re α)·|α| with phase φ = α/e — EXCEPT when Im α == 0, where
      clarfg takes its early exit and e keeps α's own sign with φ = 1.
    * steqr's 2×2 block solves via slaev2, whose (cs1, sn1) sign logic is
      reproduced verbatim; v(rt1) = (cs1·φ, sn1), v(rt2) = (−sn1·φ, cs1)
      where rt1 is the larger-|·| eigenvalue.

    Returns (λ (..., 2) DESCENDING BY VALUE — utility_cseig sortDecFLAG=1 —
    and V (..., 2, 2) complex pair with columns matching λ).  Verified
    against scipy's cheev on 3000 random Hermitian 2×2 (incl. indefinite
    and real-off-diagonal cases)."""
    a = C[0][..., 0, 0]
    c = C[0][..., 1, 1]
    r01 = C[0][..., 0, 1]
    i01 = C[1][..., 0, 1]
    tiny = jnp.float32(1e-30)
    mag = jnp.sqrt(r01 * r01 + i01 * i01)
    real_case = (i01 == 0.0)
    sgn_r = jnp.where(r01 >= 0.0, 1.0, -1.0)
    e = jnp.where(real_case, r01, -sgn_r * mag)
    e_safe = jnp.where(e == 0.0, 1.0, e)
    phi = (jnp.where(real_case, 1.0, r01 / e_safe),
           jnp.where(real_case, 0.0, i01 / e_safe))

    # --- slaev2(a, e, c), verbatim branch structure -------------------------
    sm = a + c
    df = a - c
    adf = jnp.abs(df)
    tb = e + e
    ab = jnp.abs(tb)
    adf_s = jnp.maximum(adf, tiny)
    ab_s = jnp.maximum(ab, tiny)
    rt = jnp.where(
        adf > ab, adf * jnp.sqrt(1.0 + (ab / adf_s) ** 2),
        jnp.where(adf < ab, ab * jnp.sqrt(1.0 + (adf / ab_s) ** 2),
                  ab * jnp.sqrt(jnp.float32(2.0))))
    sgn1 = jnp.where(sm < 0.0, -1.0, 1.0)
    rt1 = jnp.where(sm < 0.0, 0.5 * (sm - rt),
                    jnp.where(sm > 0.0, 0.5 * (sm + rt), 0.5 * rt))
    bigger_a = jnp.abs(a) > jnp.abs(c)    # slaev2: strict '>' picks a
    acmx = jnp.where(bigger_a, a, c)      # signed larger-|.| diagonal
    acmn = jnp.where(bigger_a, c, a)
    rt1_s = jnp.where(rt1 == 0.0, 1.0, rt1)
    rt2 = jnp.where(sm == 0.0, -0.5 * rt,
                    acmx / rt1_s * acmn - (e / rt1_s) * e)
    cs = jnp.where(df >= 0.0, df + rt, df - rt)
    sgn2 = jnp.where(df >= 0.0, 1.0, -1.0)
    acs = jnp.abs(cs)
    cs_safe = jnp.where(cs == 0.0, 1.0, cs)
    tb_safe = jnp.where(tb == 0.0, 1.0, tb)
    ct = -tb / cs_safe
    sn1_a = 1.0 / jnp.sqrt(1.0 + ct * ct)
    cs1_a = ct * sn1_a
    tn = -cs / tb_safe
    cs1_b = 1.0 / jnp.sqrt(1.0 + tn * tn)
    sn1_b = tn * cs1_b
    cs1 = jnp.where(acs > ab, cs1_a, jnp.where(ab == 0.0, 1.0, cs1_b))
    sn1 = jnp.where(acs > ab, sn1_a, jnp.where(ab == 0.0, 0.0, sn1_b))
    swap = (sgn1 == sgn2)
    cs1, sn1 = (jnp.where(swap, -sn1, cs1), jnp.where(swap, cs1, sn1))

    # columns: v(rt1) = (cs1·φ, sn1), v(rt2) = (−sn1·φ, cs1); sort
    # descending BY VALUE (rt1 is larger-|·|, not necessarily larger)
    v1 = ((cs1 * phi[0], sn1), (cs1 * phi[1], jnp.zeros_like(sn1)))
    v2 = ((-sn1 * phi[0], cs1), (-sn1 * phi[1], jnp.zeros_like(cs1)))
    first = (rt1 >= rt2)
    lam = jnp.stack([jnp.where(first, rt1, rt2),
                     jnp.where(first, rt2, rt1)], axis=-1)

    def col(i, part):
        hi = (v1[part][i], v2[part][i])
        return jnp.stack([jnp.where(first, hi[0], hi[1]),
                          jnp.where(first, hi[1], hi[0])], axis=-1)

    Vre = jnp.stack([col(0, 0), col(1, 0)], axis=-2)
    Vim = jnp.stack([col(0, 1), col(1, 1)], axis=-2)
    return lam, (Vre, Vim)


# ---------------------------------------------------------------------------
# Closed-form 2×2 decompositions (no iterative QR/Jacobi)
# ---------------------------------------------------------------------------

def herm_eig_2x2(C: Cmplx):
    """Closed-form eigendecomposition of (..., 2, 2) Hermitian RI pairs.

    Returns ``(w, V)`` with eigenvalues ``w`` (..., 2) in DESCENDING order
    and unitary eigenvector columns ``V`` (a Cmplx pair).  Batched small
    eigh/SVD otherwise lowers to iterative sweeps; the 2×2 case is one
    square root.
    """
    re, im = C
    a = re[..., 0, 0]
    b = re[..., 1, 1]
    cr = re[..., 0, 1]
    ci = im[..., 0, 1]
    c2 = cr * cr + ci * ci
    tr = a + b
    d = a - b
    rad = jnp.sqrt(d * d + 4.0 * c2)
    l1 = 0.5 * (tr + rad)
    l2 = 0.5 * (tr - rad)
    # eigenvector for λ is [c, λ − a]ᵀ (second row of (C − λI)v = 0 holds
    # because (λ−a)(λ−b) = |c|²); degenerate |c| → 0 falls back to the
    # identity pairing ordered by a ≥ b
    # |c|² at/below the f32 noise floor of the diagonal scale → treat as
    # diagonal (for degenerate spectra the off-diagonal of e.g. AᴴA is pure
    # rounding noise ~1e-7·‖·‖, and [c, λ−a] becomes a noise direction)
    small = c2 <= 1e-12 * jnp.maximum(a * a + b * b, 1e-30)
    swap = jnp.logical_and(small, a < b)

    def col(lam):
        n = jnp.sqrt(c2 + (lam - a) ** 2)
        n = jnp.maximum(n, 1e-30)
        return cr / n, ci / n, (lam - a) / n

    v1r0, v1i0, v1r1 = col(l1)
    v2r0, v2i0, v2r1 = col(l2)
    one = jnp.ones_like(a)
    zero = jnp.zeros_like(a)
    # identity pairing for |c| ≈ 0 (columns ordered so w stays descending)
    v1r0 = jnp.where(small, jnp.where(swap, zero, one), v1r0)
    v1i0 = jnp.where(small, zero, v1i0)
    v1r1 = jnp.where(small, jnp.where(swap, one, zero), v1r1)
    v2r0 = jnp.where(small, jnp.where(swap, one, zero), v2r0)
    v2i0 = jnp.where(small, zero, v2i0)
    v2r1 = jnp.where(small, jnp.where(swap, zero, one), v2r1)
    w = jnp.stack([l1, l2], axis=-1)
    Vre = jnp.stack([jnp.stack([v1r0, v2r0], -1),
                     jnp.stack([v1r1, v2r1], -1)], -2)
    Vim = jnp.stack([jnp.stack([v1i0, v2i0], -1),
                     jnp.stack([zero, zero], -1)], -2)
    return w, (Vre, Vim)


def chermitian(A: Cmplx) -> Cmplx:
    """Conjugate transpose of an RI pair."""
    return (jnp.swapaxes(A[0], -1, -2), -jnp.swapaxes(A[1], -1, -2))


def svd_2x2(A: Cmplx):
    """Closed-form SVD of general (..., 2, 2) complex RI pairs:
    A = U diag(s) Vᴴ with s descending.  Returns (U, s, V).

    Built from the closed-form eigendecomposition of AᴴA; left vectors are
    U = A V / s with an orthogonal-complement fallback for (near-)rank-1
    inputs (where the complex SVD's u₂ is only defined up to phase — any
    valid completion is chosen, as LAPACK also does arbitrarily).
    """
    B = cmatmul(chermitian(A), A)
    s2, V = herm_eig_2x2(B)
    s = jnp.sqrt(jnp.maximum(s2, 0.0))
    AV = cmatmul(A, V)
    # left vectors normalised by their ACTUAL column norms (‖A vᵢ‖ = sᵢ in
    # exact arithmetic, but for near-rank-deficient inputs the f32 direction
    # survives while the magnitude estimate from the eigenvalues does not)
    norms = jnp.sqrt(jnp.sum(AV[0] ** 2 + AV[1] ** 2, axis=-2))
    scale = jnp.maximum(norms, 1e-30)[..., None, :]
    u_re = AV[0] / scale
    u_im = AV[1] / scale
    tiny = norms <= 1e-6 * jnp.maximum(s[..., :1], 1e-30)
    # u1 fallback (A ≈ 0): e1
    e1_re = jnp.zeros_like(u_re[..., 0])
    e1_re = e1_re.at[..., 0].set(1.0)
    u1_re = jnp.where(tiny[..., 0][..., None], e1_re, u_re[..., 0])
    u1_im = jnp.where(tiny[..., 0][..., None], 0.0, u_im[..., 0])
    # u2: Gram-Schmidt against u1 UNCONDITIONALLY — for near-rank-1 inputs
    # (s2/s1 down to ~1e-5) A v2 is dominated by f32 eigenvector noise along
    # u1, which the norm check alone does not catch — then fall back to the
    # exact orthogonal complement [-conj(u1[1]), conj(u1[0])] when the
    # orthogonalised residual is negligible
    dot_re = jnp.sum(u1_re * u_re[..., 1] + u1_im * u_im[..., 1], axis=-1)
    dot_im = jnp.sum(u1_re * u_im[..., 1] - u1_im * u_re[..., 1], axis=-1)
    g_re = (u_re[..., 1] - dot_re[..., None] * u1_re
            + dot_im[..., None] * u1_im)
    g_im = (u_im[..., 1] - dot_re[..., None] * u1_im
            - dot_im[..., None] * u1_re)
    g_norm = jnp.sqrt(jnp.sum(g_re * g_re + g_im * g_im, axis=-1))
    c_re = jnp.stack([-u1_re[..., 1], u1_re[..., 0]], -1)
    c_im = jnp.stack([u1_im[..., 1], -u1_im[..., 0]], -1)
    use_c = jnp.logical_or(tiny[..., 1], g_norm <= 1e-3)[..., None]
    gs = jnp.maximum(g_norm, 1e-30)[..., None]
    u2_re = jnp.where(use_c, c_re, g_re / gs)
    u2_im = jnp.where(use_c, c_im, g_im / gs)
    U = (jnp.stack([u1_re, u2_re], -1), jnp.stack([u1_im, u2_im], -1))
    return U, s, V


# ---------------------------------------------------------------------------
# bit-faithful LAPACK cgesv for small static n (C-parity noise matching)
# ---------------------------------------------------------------------------

def _sladiv(a: jax.Array, b: jax.Array, c: jax.Array, d: jax.Array):
    """(a+ib)/(c+id) in the operation order of LAPACK sladiv/cladiv
    (Baudin-Smith; LAPACK >= 3.5, as bundled by the OpenBLAS the C
    reference goldens link).  The R==0 / B*R==0 sub-branches of SLADIV2
    are numerically identical to the main path when they trigger, so only
    the |d| <= |c| swap is materialised.  All f32, elementwise, batched.

    DIVERGENCE FROM LAPACK ON SINGULAR INPUT: a zero (or fully
    cancelling) denominator is where-guarded to 1.0 so the whole batch
    stays NaN-free under vmap/jit — LAPACK would instead produce inf/NaN
    here.  Consequently :func:`cgesv_ri` on an exactly singular pivot
    returns unspecified FINITE values rather than LAPACK's inf/NaN; its
    in-framework caller (the diagonally-loaded HADES BMVDR solve) can
    never hit this, but external callers must not rely on NaN to detect
    singularity — check the pivot magnitudes instead."""
    swap = jnp.abs(d) > jnp.abs(c)
    aa = jnp.where(swap, b, a)
    bb = jnp.where(swap, a, b)
    cc = jnp.where(swap, d, c)
    dd = jnp.where(swap, c, d)
    # SLADIV1: R = D/C; T = 1/(C + D*R); P = (A + B*R)*T; Q = (B - A*R)*T
    cc_safe = jnp.where(cc == 0.0, 1.0, cc)
    r = dd / cc_safe
    t = 1.0 / jnp.where(cc + dd * r == 0.0, 1.0, cc + dd * r)
    p = (aa + bb * r) * t
    q = (bb + (-aa) * r) * t
    return p, jnp.where(swap, -q, q)


def cgesv_ri(A: Cmplx, b: Cmplx) -> Cmplx:
    """Solve A x = b exactly as LAPACK's f32 cgesv does, batched.

    Mirrors the unblocked factorization the reference's utility_cglslv →
    LAPACKE_cgesv executes for small n (saf_utility_veclib.c; OpenBLAS
    dispatches n=6 to the reference-LAPACK cgetf2 + cgetrs):

    * partial pivoting on CABS1 = |re| + |im| (icamax), full-row swaps;
    * column scaling by ``1/a_jj`` computed ONCE via cladiv (Smith
      division) then multiplied through (cscal) — NOT per-element
      division;
    * rank-1 trailing update (cgeru), then unit-lower forward and
      non-unit-upper backward substitution in ctrsm's k-ordering.

    Everything stays f32 with the same operation ORDER, so the f32
    rounding pattern tracks the C's — this is what closes the HADES BMVDR
    output gap vs the compiled C (the residual was the C's own cgesv
    noise, not algorithmic difference; see tests/test_c_goldens.py).
    The row swaps are masked selects built from a one-hot of the pivot
    index (no gathers in the unrolled LU steps).

    A: (..., n, n) complex pair; b: (..., n) or (..., n, k) complex pair;
    n static/small (the loops unroll).  A k-RHS solve shares ONE
    factorization — exactly what two utility_cglslv calls on the same
    matrix produce, since the LU is deterministic and per-column ops are
    independent.  Returns x with b's shape.

    Singular input: unlike LAPACK (inf/NaN), an exactly singular pivot
    yields unspecified finite values (see :func:`_sladiv`); callers that
    need singularity detection must test pivots themselves.
    """
    Ar, Ai = A
    br, bi = b
    vec = br.ndim == Ar.ndim - 1
    if vec:
        br, bi = br[..., None], bi[..., None]
    n = Ar.shape[-1]
    rows = jnp.arange(n)
    col = jnp.arange(n)

    def swap_rows(M, row_j, row_p, is_j, is_p):
        # M with rows j and p exchanged, as pure elementwise selects
        return jnp.where(is_j, row_p, jnp.where(is_p, row_j, M))

    for j in range(n):
        # icamax over rows j.. of column j.  LAPACK takes the FIRST max;
        # argmax also returns the first of equal values.
        cab1 = jnp.abs(Ar[..., :, j]) + jnp.abs(Ai[..., :, j])
        p = jnp.argmax(jnp.where(rows >= j, cab1, -1.0), axis=-1)
        onehot_p = (rows == p[..., None]).astype(Ar.dtype)  # (..., n)
        is_p = (rows == p[..., None])[..., None]            # (..., n, 1)
        is_j = (rows == j)[:, None]                         # (n, 1)
        # row p extracted as a masked reduction (no gather)
        rowp_r = (Ar * onehot_p[..., None]).sum(-2, keepdims=True)
        rowp_i = (Ai * onehot_p[..., None]).sum(-2, keepdims=True)
        rowj_r = Ar[..., j:j + 1, :]
        rowj_i = Ai[..., j:j + 1, :]
        Ar = swap_rows(Ar, rowj_r, rowp_r, is_j, is_p)
        Ai = swap_rows(Ai, rowj_i, rowp_i, is_j, is_p)
        # pivot the rhs too (cgetrs applies the interchanges via claswp)
        bp_r = (br * onehot_p[..., None]).sum(-2, keepdims=True)
        bp_i = (bi * onehot_p[..., None]).sum(-2, keepdims=True)
        br = swap_rows(br, br[..., j:j + 1, :], bp_r, is_j, is_p)
        bi = swap_rows(bi, bi[..., j:j + 1, :], bp_i, is_j, is_p)
        # cgetf2 column scale: alpha = 1/a_jj (cladiv), cscal on rows j+1..
        inv_r, inv_i = _sladiv(jnp.ones_like(Ar[..., j, j]),
                               jnp.zeros_like(Ar[..., j, j]),
                               Ar[..., j, j], Ai[..., j, j])
        colr, coli = Ar[..., :, j], Ai[..., :, j]
        sr = colr * inv_r[..., None] - coli * inv_i[..., None]
        si = colr * inv_i[..., None] + coli * inv_r[..., None]
        below = rows > j
        colr = jnp.where(below, sr, colr)
        coli = jnp.where(below, si, coli)
        colmask = (col == j)
        Ar = jnp.where(colmask, colr[..., None], Ar)
        Ai = jnp.where(colmask, coli[..., None], Ai)
        # cgeru trailing update: A[i,k] -= A[i,j]*A[j,k]  (i>j, k>j)
        lr = jnp.where(below, colr, 0.0)[..., :, None]
        li = jnp.where(below, coli, 0.0)[..., :, None]
        right = col > j
        ur = jnp.where(right, Ar[..., j, :], 0.0)[..., None, :]
        ui = jnp.where(right, Ai[..., j, :], 0.0)[..., None, :]
        Ar = Ar - (lr * ur - li * ui)
        Ai = Ai - (lr * ui + li * ur)
    # ctrsm 'Left, Lower, NoTrans, Unit': b[i] -= b[k]*L[i,k], k ascending
    for k in range(n - 1):
        below = (rows > k)[:, None]
        lr = jnp.where(below, Ar[..., :, k:k + 1], 0.0)
        li = jnp.where(below, Ai[..., :, k:k + 1], 0.0)
        bkr, bki = br[..., k:k + 1, :], bi[..., k:k + 1, :]
        br = br - (bkr * lr - bki * li)
        bi = bi - (bkr * li + bki * lr)
    # ctrsm 'Left, Upper, NoTrans, NonUnit': divide then eliminate upward
    for k in range(n - 1, -1, -1):
        qr, qi = _sladiv(br[..., k, :], bi[..., k, :],
                         Ar[..., k, k, None], Ai[..., k, k, None])
        is_k = (rows == k)[:, None]
        br = jnp.where(is_k, qr[..., None, :], br)
        bi = jnp.where(is_k, qi[..., None, :], bi)
        above = (rows < k)[:, None]
        ur = jnp.where(above, Ar[..., :, k:k + 1], 0.0)
        ui = jnp.where(above, Ai[..., :, k:k + 1], 0.0)
        br = br - (qr[..., None, :] * ur - qi[..., None, :] * ui)
        bi = bi - (qr[..., None, :] * ui + qi[..., None, :] * ur)
    if vec:
        return br[..., 0], bi[..., 0]
    return br, bi
