"""Covariance-Domain Framework for Spatial Audio Processing (CDF4SAP).

Counterpart of ``saf_cdf4sap`` (Vilkamo, Backstrom & Kuntz 2013): given input
covariance Cx, target covariance Cy and a prototype matrix Q, find the
optimal mixing matrix M (and residual covariance Cr) such that
M·Cx·Mᴴ ≈ Cy while M stays maximally close to Q.

Backend-agnostic and batched: all operations are matrix ops on the last two
axes, so a (nBands, ...) stack solves every band in one call — on device
(jnp) inside an analysis/synthesis jit, or in NumPy at design time.
Real (saf_cdf4sap.c:270 ``formulate_M_and_Cr``) and complex
(saf_cdf4sap.c:404 ``formulate_M_and_Cr_cmplx``) variants share one
implementation.
"""
from __future__ import annotations

import numpy as np


def _xp(*arrays):
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


def formulate_M_and_Cr(Cx, Cy, Q, use_energy: bool = False, reg: float = 1e-2):
    """Returns (M, Cr).

    Cx: (..., nX, nX), Cy: (..., nY, nY), Q: (..., nY, nX) — real or complex.
    M: (..., nY, nX); Cr: (..., nY, nY) (zeros if use_energy).
    """
    xp = _xp(Cx, Cy, Q)
    Cx, Cy, Q = xp.asarray(Cx), xp.asarray(Cy), xp.asarray(Q)
    nX = Cx.shape[-1]
    nY = Cy.shape[-1]
    is_cplx = xp.iscomplexobj(Cx) or xp.iscomplexobj(Cy) or xp.iscomplexobj(Q)

    def H(a):
        return xp.conj(xp.swapaxes(a, -1, -2)) if is_cplx else xp.swapaxes(a, -1, -2)

    # Ky = U_Cy sqrt(S_Cy)  (saf_cdf4sap.c:293-300)
    U_cy, s_cy, _ = xp.linalg.svd(Cy)
    Ky = U_cy * xp.sqrt(xp.maximum(s_cy, 2.23e-20))[..., None, :]

    # Kx = U_Cx sqrt(S_Cx); regularised inverse (saf_cdf4sap.c:302-326)
    U_cx, s_cx, _ = xp.linalg.svd(Cx)
    s_sqrt = xp.sqrt(xp.maximum(s_cx, 2.23e-20))
    Kx = U_cx * s_sqrt[..., None, :]
    limit = xp.max(s_sqrt, axis=-1, keepdims=True) * reg + 2.23e-13
    s_inv = 1.0 / xp.maximum(s_sqrt, limit)
    Kx_reg_inv = s_inv[..., :, None] * H(U_cx)

    # normalisation matrix G_hat (saf_cdf4sap.c:328-344)
    G_full = Q @ Cx @ H(Q)
    g_diag = xp.real(xp.diagonal(G_full, axis1=-2, axis2=-1))
    g_lim = xp.max(g_diag, axis=-1, keepdims=True) * 0.001 + 2.23e-13
    cy_diag = xp.real(xp.diagonal(Cy, axis1=-2, axis2=-1))
    g_hat = xp.sqrt(xp.maximum(cy_diag, 2.23e-13) / xp.maximum(g_diag, g_lim))

    # optimal P via SVD of Kxᴴ Qᴴ G_hatᴴ Ky (saf_cdf4sap.c:346-375)
    A = H(Kx) @ H(Q) @ (g_hat[..., :, None] * Ky)
    U, _, Vh = xp.linalg.svd(A)
    V = H(Vh)
    lam = xp.zeros((nY, nX), dtype=A.dtype)
    if xp is np:
        lam[: min(nX, nY), : min(nX, nY)] = np.eye(min(nX, nY))
    else:
        lam = lam.at[: min(nX, nY), : min(nX, nY)].set(xp.eye(min(nX, nY), dtype=A.dtype))
    P = V @ lam @ H(U)

    # M and residual covariance (saf_cdf4sap.c:377-390)
    M = Ky @ P @ Kx_reg_inv
    Cy_tilde = M @ Cx @ H(M)
    Cr = Cy - Cy_tilde

    if use_energy:
        cyt_diag = xp.real(xp.diagonal(Cy_tilde, axis1=-2, axis2=-1))
        g = xp.sqrt(xp.maximum(cy_diag, 2.23e-20) / (cyt_diag + 2.23e-7))
        M = g[..., :, None] * M
        Cr = xp.zeros_like(Cr)
    return M, Cr


def formulate_M_and_Cr_ri(Cx_ri, Cy_ri, Q_ri, use_energy: bool = False,
                          reg: float = 1e-2):
    """Complex formulate_M_and_Cr in split real/imaginary arithmetic, for
    device paths that avoid complex64.

    The [[A,-B],[B,A]] embedding is a *-ring homomorphism, and the CDF
    construction is invariant to the (unitary) choice of the Cx/Cy square
    roots and to orthogonal mixing inside the embedding's duplicated
    singular pairs, so running the real implementation verbatim on the
    embedded matrices yields exactly the embedding of the complex result
    (the top-2k singular cut always lands on a pair boundary because the
    embedded spectrum is doubled).
    """
    from spatial_audio_framework_tpu.ops import herm_ri as H

    nY, nX = Q_ri[0].shape[-2:]
    if nX == 2 and nY == 2:
        return formulate_M_and_Cr_2x2_entrywise(Cx_ri, Cy_ri, Q_ri,
                                                use_energy, reg)
    M_e, Cr_e = formulate_M_and_Cr(H.herm_embed(Cx_ri), H.herm_embed(Cy_ri),
                                   H.embed_general(Q_ri), use_energy, reg)
    return H.extract_embedded(M_e, nY, nX), H.extract_embedded(Cr_e, nY, nY)


def _formulate_2x2_ri(Cx_ri, Cy_ri, Q_ri, use_energy: bool, reg: float):
    """The 2×2 case in closed form (herm_ri.herm_eig_2x2 / svd_2x2): the
    generic path's three batched SVDs lower to iterative sweeps, which
    would dominate the HADES/spreader synthesis cost for binaural (Q = 2)
    deployments.  Same recipe as formulate_M_and_Cr."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.ops import herm_ri as H

    def diag_re(C):
        return jnp.diagonal(C[0], axis1=-2, axis2=-1)

    # Ky = U_Cy sqrt(S_Cy)
    sy, Uy = H.herm_eig_2x2(Cy_ri)
    ry = jnp.sqrt(jnp.maximum(sy, 2.23e-20))[..., None, :]
    Ky = (Uy[0] * ry, Uy[1] * ry)
    # Kx and its regularised inverse
    sx, Ux = H.herm_eig_2x2(Cx_ri)
    s_sqrt = jnp.sqrt(jnp.maximum(sx, 2.23e-20))
    Kx = (Ux[0] * s_sqrt[..., None, :], Ux[1] * s_sqrt[..., None, :])
    limit = jnp.max(s_sqrt, axis=-1, keepdims=True) * reg + 2.23e-13
    s_inv = (1.0 / jnp.maximum(s_sqrt, limit))[..., :, None]
    UxH = H.chermitian(Ux)
    Kx_reg_inv = (s_inv * UxH[0], s_inv * UxH[1])
    # normalisation g_hat
    G_full = H.cmatmul(H.cmatmul(Q_ri, Cx_ri), H.chermitian(Q_ri))
    g_diag = diag_re(G_full)
    g_lim = jnp.max(g_diag, axis=-1, keepdims=True) * 0.001 + 2.23e-13
    cy_diag = diag_re(Cy_ri)
    g_hat = jnp.sqrt(jnp.maximum(cy_diag, 2.23e-13)
                     / jnp.maximum(g_diag, g_lim))[..., :, None]
    # optimal P from the closed-form SVD
    A = H.cmatmul(H.cmatmul(H.chermitian(Kx), H.chermitian(Q_ri)),
                  (g_hat * Ky[0], g_hat * Ky[1]))
    U, _, V = H.svd_2x2(A)
    P = H.cmatmul(V, H.chermitian(U))
    M = H.cmatmul(H.cmatmul(Ky, P), Kx_reg_inv)
    Cy_tilde = H.cmatmul(H.cmatmul(M, Cx_ri), H.chermitian(M))
    Cr = (Cy_ri[0] - Cy_tilde[0], Cy_ri[1] - Cy_tilde[1])
    if use_energy:
        cyt_diag = diag_re(Cy_tilde)
        g = jnp.sqrt(jnp.maximum(cy_diag, 2.23e-20)
                     / (cyt_diag + 2.23e-7))[..., :, None]
        M = (g * M[0], g * M[1])
        Cr = (jnp.zeros_like(Cr[0]), jnp.zeros_like(Cr[1]))
    return M, Cr


def formulate_M_and_Cr_cmplx(Cx, Cy, Q, use_energy: bool = False,
                             reg: float = 1e-2):
    """Complex variant (saf_cdf4sap.c:404) — same math via the shared
    implementation; kept for API parity."""
    xp = _xp(Cx, Cy, Q)
    cplx = np.complex128 if xp is np else xp.complex64
    return formulate_M_and_Cr(xp.asarray(Cx).astype(cplx),
                              Cy, Q, use_energy, reg)


# ---------------------------------------------------------------------------
# Entrywise 2×2 pipeline: the same closed forms with every 2×2 held as FOUR
# scalar complex entries (batch dims on the minor axis) instead of
# (..., 2, 2) arrays, so every step is one elementwise op over the batch
# instead of many tiny 2×2 ops.  Numerics identical to _formulate_2x2_ri up to f32 op reordering.
# ---------------------------------------------------------------------------

def _s_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _s_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _s_conj(a):
    return (a[0], -a[1])


def _s_scale(r, a):
    """real r × complex a."""
    return (r * a[0], r * a[1])


def _m2_mul(A, B):
    """2×2 entry-form matmul: A, B = ((e00, e01), (e10, e11)) of (re, im)."""
    return tuple(
        tuple(_s_add(_s_mul(A[i][0], B[0][j]), _s_mul(A[i][1], B[1][j]))
              for j in (0, 1))
        for i in (0, 1))


def _m2_herm(A):
    return ((_s_conj(A[0][0]), _s_conj(A[1][0])),
            (_s_conj(A[0][1]), _s_conj(A[1][1])))


def _m2_from(C_ri):
    """(..., 2, 2) RI pair → entry form."""
    return tuple(
        tuple((C_ri[0][..., i, j], C_ri[1][..., i, j]) for j in (0, 1))
        for i in (0, 1))


def _m2_to(A):
    import jax.numpy as jnp

    re = jnp.stack([jnp.stack([A[0][0][0], A[0][1][0]], -1),
                    jnp.stack([A[1][0][0], A[1][1][0]], -1)], -2)
    im = jnp.stack([jnp.stack([A[0][0][1], A[0][1][1]], -1),
                    jnp.stack([A[1][0][1], A[1][1][1]], -1)], -2)
    return re, im


def _herm_eig_2x2_e(a, b, cr, ci):
    """herm_ri.herm_eig_2x2 in entry form: Hermitian [[a, c],[c̄, b]] →
    (l1, l2 descending, V entry-form with real second row)."""
    import jax.numpy as jnp

    c2 = cr * cr + ci * ci
    tr = a + b
    d = a - b
    rad = jnp.sqrt(d * d + 4.0 * c2)
    l1 = 0.5 * (tr + rad)
    l2 = 0.5 * (tr - rad)
    small = c2 <= 1e-12 * jnp.maximum(a * a + b * b, 1e-30)
    swap = jnp.logical_and(small, a < b)

    def col(lam):
        n = jnp.maximum(jnp.sqrt(c2 + (lam - a) ** 2), 1e-30)
        return cr / n, ci / n, (lam - a) / n

    v1r0, v1i0, v1r1 = col(l1)
    v2r0, v2i0, v2r1 = col(l2)
    one = jnp.ones_like(a)
    zero = jnp.zeros_like(a)
    v1r0 = jnp.where(small, jnp.where(swap, zero, one), v1r0)
    v1i0 = jnp.where(small, zero, v1i0)
    v1r1 = jnp.where(small, jnp.where(swap, one, zero), v1r1)
    v2r0 = jnp.where(small, jnp.where(swap, one, zero), v2r0)
    v2i0 = jnp.where(small, zero, v2i0)
    v2r1 = jnp.where(small, jnp.where(swap, zero, one), v2r1)
    V = (((v1r0, v1i0), (v2r0, v2i0)),
         ((v1r1, zero), (v2r1, zero)))
    return l1, l2, V


def _svd_2x2_e(A):
    """herm_ri.svd_2x2 in entry form → (U, (s1, s2), V), same fallbacks."""
    import jax.numpy as jnp

    B = _m2_mul(_m2_herm(A), A)           # Hermitian
    a_d = B[0][0][0]
    b_d = B[1][1][0]
    cr, ci = B[0][1]
    s21, s22, V = _herm_eig_2x2_e(a_d, b_d, cr, ci)
    s1 = jnp.sqrt(jnp.maximum(s21, 0.0))
    s2 = jnp.sqrt(jnp.maximum(s22, 0.0))
    AV = _m2_mul(A, V)

    def colnorm(k):
        return jnp.sqrt(AV[0][k][0] ** 2 + AV[0][k][1] ** 2
                        + AV[1][k][0] ** 2 + AV[1][k][1] ** 2)

    n1 = colnorm(0)
    n2 = colnorm(1)
    inv1 = 1.0 / jnp.maximum(n1, 1e-30)
    inv2 = 1.0 / jnp.maximum(n2, 1e-30)
    u1 = (_s_scale(inv1, AV[0][0]), _s_scale(inv1, AV[1][0]))
    u2r = (_s_scale(inv2, AV[0][1]), _s_scale(inv2, AV[1][1]))
    tiny1 = n1 <= 1e-6 * jnp.maximum(s1, 1e-30)
    tiny2 = n2 <= 1e-6 * jnp.maximum(s1, 1e-30)
    one = jnp.ones_like(n1)
    zero = jnp.zeros_like(n1)
    u1 = ((jnp.where(tiny1, one, u1[0][0]), jnp.where(tiny1, zero, u1[0][1])),
          (jnp.where(tiny1, zero, u1[1][0]), jnp.where(tiny1, zero, u1[1][1])))
    # Gram-Schmidt u2 against u1, with orthogonal-complement fallback
    dot = _s_add(_s_mul(_s_conj(u1[0]), u2r[0]), _s_mul(_s_conj(u1[1]), u2r[1]))
    g0 = (u2r[0][0] - (dot[0] * u1[0][0] - dot[1] * u1[0][1]),
          u2r[0][1] - (dot[0] * u1[0][1] + dot[1] * u1[0][0]))
    g1 = (u2r[1][0] - (dot[0] * u1[1][0] - dot[1] * u1[1][1]),
          u2r[1][1] - (dot[0] * u1[1][1] + dot[1] * u1[1][0]))
    g_norm = jnp.sqrt(g0[0] ** 2 + g0[1] ** 2 + g1[0] ** 2 + g1[1] ** 2)
    c0 = (-u1[1][0], u1[1][1])            # -conj? matches svd_2x2: (-u1_re[1], u1_im[1])
    c1 = (u1[0][0], -u1[0][1])
    use_c = jnp.logical_or(tiny2, g_norm <= 1e-3)
    ginv = 1.0 / jnp.maximum(g_norm, 1e-30)
    u2 = ((jnp.where(use_c, c0[0], g0[0] * ginv),
           jnp.where(use_c, c0[1], g0[1] * ginv)),
          (jnp.where(use_c, c1[0], g1[0] * ginv),
           jnp.where(use_c, c1[1], g1[1] * ginv)))
    U = ((u1[0], u2[0]), (u1[1], u2[1]))
    return U, (s1, s2), V


def formulate_M_and_Cr_2x2_entrywise(Cx_ri, Cy_ri, Q_ri, use_energy: bool,
                                     reg: float):
    """_formulate_2x2_ri with every 2×2 in entry form end-to-end."""
    import jax.numpy as jnp

    Cx = _m2_from(Cx_ri)
    Cy = _m2_from(Cy_ri)
    Q = _m2_from(Q_ri)

    # Ky = U_Cy sqrt(S_Cy)
    sy1, sy2, Uy = _herm_eig_2x2_e(Cy[0][0][0], Cy[1][1][0], *Cy[0][1])
    ry1 = jnp.sqrt(jnp.maximum(sy1, 2.23e-20))
    ry2 = jnp.sqrt(jnp.maximum(sy2, 2.23e-20))
    Ky = ((_s_scale(ry1, Uy[0][0]), _s_scale(ry2, Uy[0][1])),
          (_s_scale(ry1, Uy[1][0]), _s_scale(ry2, Uy[1][1])))
    # Kx and its regularised inverse
    sx1, sx2, Ux = _herm_eig_2x2_e(Cx[0][0][0], Cx[1][1][0], *Cx[0][1])
    sq1 = jnp.sqrt(jnp.maximum(sx1, 2.23e-20))
    sq2 = jnp.sqrt(jnp.maximum(sx2, 2.23e-20))
    Kx = ((_s_scale(sq1, Ux[0][0]), _s_scale(sq2, Ux[0][1])),
          (_s_scale(sq1, Ux[1][0]), _s_scale(sq2, Ux[1][1])))
    limit = jnp.maximum(sq1, sq2) * reg + 2.23e-13
    si1 = 1.0 / jnp.maximum(sq1, limit)
    si2 = 1.0 / jnp.maximum(sq2, limit)
    UxH = _m2_herm(Ux)
    Kxri = ((_s_scale(si1, UxH[0][0]), _s_scale(si1, UxH[0][1])),
            (_s_scale(si2, UxH[1][0]), _s_scale(si2, UxH[1][1])))
    # normalisation g_hat (rows scaled)
    G = _m2_mul(_m2_mul(Q, Cx), _m2_herm(Q))
    g0 = G[0][0][0]
    g1 = G[1][1][0]
    g_lim = jnp.maximum(g0, g1) * 0.001 + 2.23e-13
    cy0 = Cy[0][0][0]
    cy1 = Cy[1][1][0]
    gh0 = jnp.sqrt(jnp.maximum(cy0, 2.23e-13) / jnp.maximum(g0, g_lim))
    gh1 = jnp.sqrt(jnp.maximum(cy1, 2.23e-13) / jnp.maximum(g1, g_lim))
    gKy = ((_s_scale(gh0, Ky[0][0]), _s_scale(gh0, Ky[0][1])),
           (_s_scale(gh1, Ky[1][0]), _s_scale(gh1, Ky[1][1])))
    A = _m2_mul(_m2_mul(_m2_herm(Kx), _m2_herm(Q)), gKy)
    U, _s, V = _svd_2x2_e(A)
    P = _m2_mul(V, _m2_herm(U))
    M = _m2_mul(_m2_mul(Ky, P), Kxri)
    Cyt = _m2_mul(_m2_mul(M, Cx), _m2_herm(M))
    Cr = tuple(tuple((Cy[i][j][0] - Cyt[i][j][0], Cy[i][j][1] - Cyt[i][j][1])
                     for j in (0, 1)) for i in (0, 1))
    if use_energy:
        e0 = jnp.sqrt(jnp.maximum(cy0, 2.23e-20) / (Cyt[0][0][0] + 2.23e-7))
        e1 = jnp.sqrt(jnp.maximum(cy1, 2.23e-20) / (Cyt[1][1][0] + 2.23e-7))
        M = ((_s_scale(e0, M[0][0]), _s_scale(e0, M[0][1])),
             (_s_scale(e1, M[1][0]), _s_scale(e1, M[1][1])))
        z = jnp.zeros_like(cy0)
        Cr = (((z, z), (z, z)), ((z, z), (z, z)))
    return _m2_to(M), _m2_to(Cr)
