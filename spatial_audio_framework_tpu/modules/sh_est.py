"""SH-domain DoA estimators and activity maps (counterpart of the estimator
half of ``saf_sh``: saf_sh.h:691-952).

Backend-agnostic & batched where useful: the powermaps are einsums over a
steering grid (device-friendly); the eigendecompositions run per covariance
matrix (host NumPy or jnp).
"""
from __future__ import annotations

import numpy as np

from spatial_audio_framework_tpu.modules import sh as _sh


def _xp(*arrays):
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


# ---------------------------------------------------------------------------
# Activity maps (saf_sh.h:842-952)
# ---------------------------------------------------------------------------

def generate_pwd_map(Cx, Y_grid):
    """Plane-wave-decomposition powermap: real(diag(Yᵀ Cx Y))
    (saf_sh.c ``generatePWDmap``).  Cx: (..., nSH, nSH); Y_grid: (nSH, nGrid)."""
    xp = _xp(Cx, Y_grid)
    return xp.real(xp.einsum("sg,...st,tg->...g", Y_grid, Cx, Y_grid))


def generate_mvdr_map(Cx, Y_grid, reg_par: float = 8.0, return_weights=False):
    """MVDR powermap (saf_sh.c ``generateMVDRmap``).  reg_par scales the
    mean-trace diagonal loading."""
    xp = _xp(Cx, Y_grid)
    nsh = Y_grid.shape[0]
    tr = xp.real(xp.trace(Cx, axis1=-2, axis2=-1)) / nsh
    Cx_d = Cx + (reg_par * tr)[..., None, None] * xp.eye(nsh, dtype=Cx.dtype)
    invCx_Y = xp.linalg.solve(Cx_d, xp.broadcast_to(Y_grid, Cx.shape[:-2] + Y_grid.shape))
    denom = xp.einsum("sg,...sg->...g", Y_grid, xp.conj(invCx_Y))
    w = invCx_Y / denom[..., None, :]
    pmap = xp.real(xp.einsum("...sg,...st,...tg->...g", w, Cx, w))
    return (pmap, w) if return_weights else pmap


def generate_cropac_lcmv_map(Cx, Y_grid, reg_par: float = 8.0,
                             lambda_floor: float = 0.0):
    """Cross-pattern-coherence LCMV map (saf_sh.c ``generateCroPaCLCMVmap``;
    Delikaris-Manias et al.).  NumPy host implementation."""
    Cx = np.asarray(Cx)
    Y = np.asarray(Y_grid)
    nsh, n_grid = Y.shape
    mvdr_map, w_mvdr = generate_mvdr_map(Cx, Y, reg_par, return_weights=True)
    Cx_Y = Cx @ Y
    tr = np.real(np.trace(Cx)) / nsh
    Cx_d = Cx + reg_par * tr * np.eye(nsh, dtype=Cx.dtype)
    d = np.diag(Cx)
    w_out = np.array(w_mvdr, complex)
    for g in range(n_grid):
        A = np.stack([Y[:, g], Y[:, g] * d], -1)  # (nSH, 2)
        invCxd_A = np.linalg.solve(Cx_d, A)
        M2 = A.conj().T @ invCxd_A.conj()
        w_lcmv = np.linalg.solve(M2, invCxd_A.T)  # (2, nSH)
        wo = w_lcmv.T @ np.array([1.0, 0.0])      # (nSH,)
        xspec = wo @ Cx_Y[:, g]
        S = min(abs(xspec), mvdr_map[g])
        G = max(lambda_floor, np.sqrt(S / (mvdr_map[g] + 2.23e-10)))
        w_out[:, g] *= G
    return generate_pwd_map(Cx, w_out)


def _noise_subspace(Cx, n_sources: int):
    xp = _xp(Cx)
    nsh = Cx.shape[-1]
    n_sources = min(n_sources, nsh // 2)
    _, V = xp.linalg.eigh(Cx)       # ascending
    V = V[..., ::-1]                # descending (utility_cseig sortDecFLAG)
    return V[..., n_sources:]


def generate_music_map(Cx, Y_grid, n_sources: int, log_scale: bool = False):
    """MUSIC pseudo-spectrum (saf_sh.c ``generateMUSICmap``)."""
    xp = _xp(Cx, Y_grid)
    Vn = _noise_subspace(Cx, n_sources)  # (..., nSH, nSH-K)
    VnY = xp.einsum("...sk,sg->...kg", Vn, Y_grid.astype(Vn.dtype))
    p = 1.0 / (xp.sum(xp.abs(VnY) ** 2, axis=-2) + 2.23e-10)
    return xp.log(p) if log_scale else p


def generate_minnorm_map(Cx, Y_grid, n_sources: int, log_scale: bool = False):
    """Minimum-norm pseudo-spectrum (saf_sh.c ``generateMinNormMap``)."""
    xp = _xp(Cx, Y_grid)
    Vn = _noise_subspace(Cx, n_sources)
    Vn1 = Vn[..., 0, :]  # first row
    un = xp.einsum("...sk,...k->...s", Vn, xp.conj(Vn1))
    un = un / (xp.einsum("...k,...k->...", Vn1, Vn1) + 2.23e-9)[..., None]
    UnY = xp.einsum("...s,sg->...g", xp.conj(un), Y_grid.astype(un.dtype))
    p = 1.0 / (xp.abs(UnY) ** 2 + 2.23e-9)
    return xp.log(p) if log_scale else p


# ---------------------------------------------------------------------------
# Activity maps in split real/imaginary arithmetic (no complex64).
# Cx is an (A, B) = (re, im) pair; Y_grid is REAL SH steering (nSH, nGrid).
# Same math as the complex versions above via the Hermitian real embedding
# (ops.herm_ri); used by the powermap/sldoa/dirass device fast paths.
# ---------------------------------------------------------------------------

def generate_pwd_map_ri(Cx_ri, Y_grid):
    """PWD map with real steering: only Re(Cx) contributes."""
    from spatial_audio_framework_tpu.ops import herm_ri as H

    return H.herm_quadform_real(Cx_ri, Y_grid)


def generate_mvdr_map_ri(Cx_ri, Y_grid, reg_par: float = 8.0,
                         return_weights=False):
    """generate_mvdr_map on an (re, im) covariance pair."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.ops import herm_ri as H

    A, B = Cx_ri
    nsh = Y_grid.shape[0]
    tr = jnp.trace(A, axis1=-2, axis2=-1) / nsh
    A_d = A + (reg_par * tr)[..., None, None] * jnp.eye(nsh, dtype=A.dtype)
    Yb = jnp.broadcast_to(Y_grid, A.shape[:-2] + Y_grid.shape)
    X = H.herm_solve((A_d, B), (Yb, jnp.zeros_like(Yb)))  # invCx_d @ Y
    # denom = yᵀ conj(X) per column
    den = (jnp.einsum("sg,...sg->...g", Y_grid, X[0]),
           -jnp.einsum("sg,...sg->...g", Y_grid, X[1]))
    w = H.cdiv((X[0], X[1]), (den[0][..., None, :], den[1][..., None, :]))
    pmap = H.quadform_trans((A, B), w)
    return (pmap, w) if return_weights else pmap


def generate_music_map_ri(Cx_ri, Y_grid, n_sources: int,
                          log_scale: bool = False):
    """MUSIC pseudo-spectrum on an (re, im) covariance pair: the noise-
    subspace quadratic form runs as one real eigh of the 2n×2n embedding."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.ops import herm_ri as H

    nsh = Cx_ri[0].shape[-1]
    n_sources = min(n_sources, nsh // 2)
    q = H.signal_subspace_quadform(Cx_ri, n_sources, Y_grid)
    p = 1.0 / (q + 2.23e-10)
    return jnp.log(p) if log_scale else p


def generate_minnorm_map_ri(Cx_ri, Y_grid, n_sources: int,
                            log_scale: bool = False):
    """Minimum-norm pseudo-spectrum on an (re, im) pair.  The minimum-norm
    vector is expressed through the noise projector: u_n = P_n e₁ / (e₁ᵀ P_n
    e₁) (Hermitian normalisation; the reference's no-conj dot depends on
    LAPACK eigenvector phases and only changes the map's global scale)."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.ops import herm_ri as H

    nsh = Cx_ri[0].shape[-1]
    n_sources = min(n_sources, nsh // 2)
    Pre, Pim = H.noise_projector(Cx_ri, n_sources)
    scale = Pre[..., 0, 0][..., None] + 2.23e-9
    un = (Pre[..., :, 0] / scale, Pim[..., :, 0] / scale)  # (..., nSH)
    # |conj(un)ᵀ y|² = (un_reᵀ y)² + (un_imᵀ y)²
    re = jnp.einsum("...s,sg->...g", un[0], Y_grid)
    im = jnp.einsum("...s,sg->...g", un[1], Y_grid)
    p = 1.0 / (re ** 2 + im ** 2 + 2.23e-9)
    return jnp.log(p) if log_scale else p


def generate_cropac_lcmv_map_ri(Cx_ri, Y_grid, reg_par: float = 8.0,
                                lambda_floor: float = 0.0):
    """Cross-pattern-coherence LCMV map on an (re, im) pair — fully batched
    over the grid (the reference's per-direction loop, saf_sh.c
    ``generateCroPaCLCMVmap``, becomes batched 2×2 solves)."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.ops import herm_ri as H

    A, B = Cx_ri
    nsh, n_grid = Y_grid.shape
    mvdr_map, w_mvdr = generate_mvdr_map_ri(Cx_ri, Y_grid, reg_par,
                                            return_weights=True)
    CxY = (A @ Y_grid, B @ Y_grid)                      # (..., nSH, g)
    tr = jnp.trace(A, axis1=-2, axis2=-1) / nsh
    A_d = A + (reg_par * tr)[..., None, None] * jnp.eye(nsh, dtype=A.dtype)
    d = jnp.diagonal(A, axis1=-2, axis2=-1)             # real diag of Hermitian
    # steering pair per grid dir: columns [y_g, y_g*d] — both REAL
    Ag = jnp.stack([jnp.broadcast_to(Y_grid, A.shape[:-2] + Y_grid.shape),
                    d[..., :, None] * Y_grid], axis=-1)  # (..., nSH, g, 2)
    Af = Ag.reshape(*Ag.shape[:-2], n_grid * 2)
    X = H.herm_solve((A_d, B), (Af, jnp.zeros_like(Af)))
    Xre = X[0].reshape(*A.shape[:-1], n_grid, 2)
    Xim = X[1].reshape(*A.shape[:-1], n_grid, 2)
    # M2 = Aᴴ conj(invCxd_A): A real → M2 = Aᵀ conj(X)  (..., g, 2, 2)
    M2 = (jnp.einsum("...sgi,...sgj->...gij", Ag, Xre),
          -jnp.einsum("...sgi,...sgj->...gij", Ag, Xim))
    # w_lcmv = M2⁻¹ Xᵀ, take the [1, 0] combination → first row of M2⁻¹ Xᵀ
    e1 = jnp.zeros((2, 1), A.dtype).at[0, 0].set(1.0)
    e1 = jnp.broadcast_to(e1, M2[0].shape[:-2] + (2, 1))
    s = H.herm_solve(M2, (e1, jnp.zeros_like(e1)))      # (..., g, 2, 1)
    # wo_j = Σ_i conj(s_i) X_{ji}  (the reference's w_lcmv.T @ [1,0] row)
    wo = (jnp.einsum("...sgi,...gi->...sg", Xre, s[0][..., 0])
          + jnp.einsum("...sgi,...gi->...sg", Xim, s[1][..., 0]),
          jnp.einsum("...sgi,...gi->...sg", Xim, s[0][..., 0])
          - jnp.einsum("...sgi,...gi->...sg", Xre, s[1][..., 0]))
    # cross-spectrum: woᵀ (Cx y_g)
    xs = H.ceinsum("...sg,...sg->...g", wo, CxY)
    S = jnp.minimum(jnp.sqrt(H.cabs2(xs)), mvdr_map)
    G = jnp.maximum(lambda_floor,
                    jnp.sqrt(S / (mvdr_map + 2.23e-10)))
    w_sc = (w_mvdr[0] * G[..., None, :], w_mvdr[1] * G[..., None, :])
    # pwd with the scaled complex weights (reference NO_CONJ convention)
    return H.quadform_trans(Cx_ri, w_sc)


# ---------------------------------------------------------------------------
# Grid-search DoA estimators with von-Mises peak masking (saf_sh.h:691-769)
# ---------------------------------------------------------------------------

def find_peaks_vonmises(p_spec: np.ndarray, grid_dirs_deg: np.ndarray,
                        n_peaks: int, kappa: float = 50.0) -> np.ndarray:
    """Iterative peak finding, masking each found peak with an inverse
    von-Mises kernel (sphPWD_compute / sphMUSIC_compute)."""
    from spatial_audio_framework_tpu.utils.geometry import unit_sph2cart

    u = np.asarray(unit_sph2cart(np.asarray(grid_dirs_deg, np.float64),
                                 degrees=True))
    scale = kappa / (2.0 * np.pi * np.exp(kappa) - np.exp(-kappa))
    p = np.array(p_spec, np.float64, copy=True)
    peaks = np.zeros(n_peaks, int)
    for k in range(n_peaks):
        peaks[k] = int(np.argmax(p))
        if k == n_peaks - 1:
            break
        vm = scale * np.exp(kappa * (u @ u[peaks[k]]))
        p = p * (1.0 / (1e-5 + vm))
    return peaks


def sph_pwd(Cx, grid_dirs_deg, n_sources: int):
    """sphPWD: steered-response power + peak finding → (peak_idx, p_spec)."""
    dirs_rad = np.stack([np.radians(grid_dirs_deg[:, 0]),
                         np.pi / 2 - np.radians(grid_dirs_deg[:, 1])], -1)
    Y = _sh.get_sh_real(int(np.sqrt(Cx.shape[-1])) - 1, dirs_rad)
    p = np.asarray(generate_pwd_map(Cx, Y.astype(Cx.dtype)))
    return find_peaks_vonmises(p, grid_dirs_deg, n_sources), p


def sph_music(Cx, grid_dirs_deg, n_sources: int):
    """sphMUSIC: subspace pseudo-spectrum + peak finding."""
    dirs_rad = np.stack([np.radians(grid_dirs_deg[:, 0]),
                         np.pi / 2 - np.radians(grid_dirs_deg[:, 1])], -1)
    Y = _sh.get_sh_real(int(np.sqrt(Cx.shape[-1])) - 1, dirs_rad)
    p = np.asarray(generate_music_map(Cx, Y.astype(Cx.dtype), n_sources))
    return find_peaks_vonmises(p, grid_dirs_deg, n_sources), p


# ---------------------------------------------------------------------------
# sphESPRIT (saf_sh.h:798-823; Jo & Choi 2018)
# ---------------------------------------------------------------------------

def _w_nimu(order, mm, ni, mu):
    n, m = _nm_grid(order)
    if mm == 1:
        n2, m2 = n + ni, m + mu
    else:
        n2, m2 = n + ni, -m + mu
    return np.sqrt((n2 - m2 - 1.0) * (n2 - m2) / ((2 * n2 - 1.0) * (2 * n2 + 1.0)))


def _v_nimu(order, ni, mu):
    n, m = _nm_grid(order)
    n2, m2 = n + ni, m + mu
    return np.sqrt((n2 - m2) * (n2 + m2) / ((2 * n2 - 1.0) * (2 * n2 + 1.0)))


def _nm_grid(order):
    n = np.concatenate([[nn] * (2 * nn + 1) for nn in range(order)])
    m = np.concatenate([np.arange(-nn, nn + 1) for nn in range(order)])
    return n.astype(float), m.astype(float)


def _muni2q(order, ni, mu):
    n, m = _nm_grid(order)
    n, m = n.astype(int), m.astype(int)
    n2, m2 = n + ni, m + mu
    valid = np.abs(m2) <= n2
    q_nm = (n * n + n + m)[valid]
    q_nimu = (n2 * n2 + n2 + m2)[valid]
    return q_nm, q_nimu  # (dest rows in the (order)² set, source ACN rows)


def sph_esprit(Us: np.ndarray) -> np.ndarray:
    """Estimate K DoAs from the complex-SH signal subspace Us (nSH, K)
    (saf_sh.c ``sphESPRIT_estimateDirs``; Jo & Choi 2018).

    Convention note: Us must be in the basis SAF feeds it — real-SH signals
    transformed by conj(real2complexSHMtx) (test__sh_module.c:632-647), which
    equals CONJUGATED physics-convention complex SH.  The recurrence uses
    rows up to (order-1)², K ≤ order² sources.  → (K, 2) [azi, elev] rad."""
    from scipy.linalg import eig as geig

    nsh, K = Us.shape
    N = int(np.sqrt(nsh)) - 1  # SH order of Us
    order = N  # recurrence operates on rows 0..order²-1
    NN = order * order
    Us = np.asarray(Us, np.complex128)

    def sel(ni, mu):
        dst, src = _muni2q(order, ni, mu)
        out = np.zeros((NN, K), np.complex128)
        out[dst] = Us[src]
        return out

    W0 = _w_nimu(order, 1, 1, -1)
    W1 = _w_nimu(order, -1, 0, 0)
    W2 = _w_nimu(order, -1, 1, -1)
    W3 = _w_nimu(order, 1, 0, 0)
    V4 = _v_nimu(order, 0, 0)
    V5 = _v_nimu(order, 1, 0)

    # NOTE the first product uses WVnimu[0]ᵀ (CblasTrans in the reference);
    # all matrices are diagonal so the transpose is a no-op, kept for parity.
    lam_xy_p = W0[:, None] * sel(1, -1) - W1[:, None] * sel(-1, -1)
    lam_xy_m = -(W2[:, None] * sel(1, 1)) + W3[:, None] * sel(-1, 1)
    lam_z = V4[:, None] * sel(-1, 0) + V5[:, None] * sel(1, 0)

    pinv_Us = np.linalg.pinv(Us[:NN])
    psi_xy_p = pinv_Us @ lam_xy_p
    psi_xy_m = pinv_Us @ lam_xy_m
    psi_z = pinv_Us @ lam_z

    # joint diagonalisation: generalized eig of (PsiXYp, PsiZ)
    _, V = geig(psi_xy_p, psi_z)
    Vinv = np.linalg.inv(V)
    phi_xy_p = np.diag(Vinv @ psi_xy_p @ V)
    phi_xy_m = np.diag(Vinv @ psi_xy_m @ V)
    phi_z = np.diag(Vinv @ psi_z @ V)

    phi_x = (phi_xy_p.real + phi_xy_m.real) / 2.0
    phi_y = ((phi_xy_p - phi_xy_m) / 2j).real
    azi = np.arctan2(phi_y, phi_x)
    elev = np.minimum(np.arctan2(phi_z.real, np.sqrt(phi_x ** 2 + phi_y ** 2)),
                      np.pi / 2)
    return np.stack([azi, elev], -1)
