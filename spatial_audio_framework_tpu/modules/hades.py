"""HADES — parametric binaural renderer for hearing-assistive devices
(counterpart of ``saf_hades``: saf_hades_analysis.h / saf_hades_synthesis.h).

* Analysis (``HadesAnalysis``): afSTFT → per-band SCM with temporal averaging
  → diffuse whitening (from the array's theoretical diffuse covariance) →
  eigen-decomposition → COMEDIE diffuseness + sdMUSIC DoA over whitened
  array steering vectors (saf_hades_analysis.c:244-357).
* Synthesis (``HadesSynthesis``): per band, direct stream via filter-and-sum
  or binaural-MVDR beamformers expressed as relative transfer functions
  w.r.t. reference sensors + HRTF re-mapping, diffuse stream via reference
  sensors × diffuse EQ; stream-balance/EQ biasing; optional covariance
  matching via CDF4SAP (saf_hades_synthesis.c:308-470).

The whole per-band chain — SCM, whitening, the eigh behind
COMEDIE/sdMUSIC, the beamformer solves and the CDF4SAP covariance matching —
runs as ONE jitted computation batched over all 133 bands, in split
real/imaginary arithmetic (ops.herm_ri; the reference's band loop at
saf_hades_analysis.c:284 becomes batched linear algebra).  Only the
parameter containers stay on host, mirroring hades_param_container /
hades_signal_container.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np

from spatial_audio_framework_tpu.modules import cdf4sap, hrir as hrir_mod
from spatial_audio_framework_tpu.ops import afstft_ri as ri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.ops import precision as _prec

HADES_USE_COMEDIE = "comedie"
HADES_USE_MUSIC = "music"
HADES_BEAMFORMER_NONE = "none"
HADES_BEAMFORMER_FILTER_AND_SUM = "filter_and_sum"
HADES_BEAMFORMER_BMVDR = "bmvdr"
HADES_HRTF_INTERP_NEAREST = "nearest"
HADES_HRTF_INTERP_TRIANGULAR = "triangular"


def comedie(evals: np.ndarray) -> float:
    """COMEDIE diffuseness from eigenvalues (saf_hades_internal.c:242)."""
    lam = np.asarray(evals, np.float64)
    N = lam.shape[-1]
    nord = np.sqrt(N) - 1.0
    s = lam.sum()
    if s < 1e-4:
        return 1.0
    g0 = 2.0 * ((nord + 1.0) ** 2 - 1.0)
    mean_ev = s / (nord + 1.0) ** 2
    g = np.abs(lam - mean_ev).sum() / mean_ev
    return float(max(1.0 - g / g0, 0.0))


def comedie_batch(lam):
    """comedie() vectorised over leading axes (traced jnp)."""
    import jax.numpy as jnp

    N = lam.shape[-1]
    nord = np.sqrt(N) - 1.0
    s = lam.sum(-1)
    g0 = 2.0 * ((nord + 1.0) ** 2 - 1.0)
    mean_ev = s / (nord + 1.0) ** 2
    g = jnp.abs(lam - mean_ev[..., None]).sum(-1) / (mean_ev + 2.23e-13)
    out = jnp.maximum(1.0 - g / g0, 0.0)
    return jnp.where(s < 1e-4, 1.0, out)


@dataclass
class HadesParams:
    """hades_param_container (saf_hades_analysis.h:221-253)."""
    diffuseness: np.ndarray   # (nBands,)
    doa_idx: np.ndarray       # (nBands,) int
    gains_idx: np.ndarray
    gains_dir: np.ndarray
    gains_diff: np.ndarray


@dataclass
class HadesSignals:
    """hades_signal_container.  inTF/Cx are (re, im) float pairs — the
    device pipeline is complex-free."""
    inTF: tuple   # ((nBands, nMics, H), ×2)
    Cx: tuple     # ((nBands, nMics, nMics), ×2) instantaneous SCMs


def _split(a: np.ndarray):
    import jax.numpy as jnp

    a = np.asarray(a)
    return (jnp.asarray(a.real.astype(np.float32)),
            jnp.asarray(a.imag.astype(np.float32)))


class HadesAnalysis:
    def __init__(self, fs: float = 48000.0, hop: int = 128,
                 h_array: Optional[np.ndarray] = None,
                 grid_dirs_deg: Optional[np.ndarray] = None,
                 diff_opt: str = HADES_USE_COMEDIE,
                 doa_opt: str = HADES_USE_MUSIC,
                 blocksize: Optional[int] = None,
                 hybrid: bool = True, low_delay: bool = False):
        """h_array: (nGrid, nMics, h_len) measured array IRs; defaults to the
        default HRIR set (binaural 2-mic array)."""
        import jax.numpy as jnp

        if h_array is None:
            h_array, grid_dirs_deg, h_fs = hrir_mod.default_hrirs()
            h_array = h_array[::4]
            grid_dirs_deg = grid_dirs_deg[::4]
            del h_fs
        self.fs, self.hop = fs, hop
        self.bank = AfSTFT(hop=hop, hybrid=hybrid, low_delay=low_delay)
        self.n_mics = h_array.shape[1]
        self.n_grid = h_array.shape[0]
        self.grid_dirs_deg = np.asarray(grid_dirs_deg)
        # scale by the SIGNED value of the largest-magnitude tap
        # (hades_analysis_create:94-95: isamax index, then 1/h[idx] — the
        # scale is negative when the extreme tap is)
        h_array = np.asarray(h_array, np.float32)
        h_array = h_array / h_array.flat[np.abs(h_array).argmax()]
        self.freq_vector = self.bank.centre_freqs(fs)
        self.n_bands = self.bank.n_bands
        self.H_array = hrir_mod.hrirs_to_hrtfs_afstft(
            h_array, hop, low_delay=low_delay, hybrid=hybrid)  # (nB,nM,nG)
        # integration weights (hades_analysis_create:122-132): raw Voronoi
        # areas, or identity when the grid is horizontal-only
        if np.abs(self.grid_dirs_deg[:, 1]).sum() / self.n_grid < 1e-4:
            w = np.ones(self.n_grid, np.float64)
        else:
            w = geo.get_voronoi_weights(self.grid_dirs_deg).astype(np.float64)
        self.int_weights = w
        # diffuse covariance + whitening matrices (hades_analysis_create)
        self.DCM = np.einsum("bmg,g,bng->bmn", self.H_array, w / self.n_grid,
                             self.H_array.conj())
        T = np.zeros_like(self.DCM)
        for b in range(self.n_bands):
            e, U = np.linalg.eigh(self.DCM[b])
            e = e[::-1]
            U = U[:, ::-1]
            T[b] = np.diag(np.sqrt(1.0 / (e.real + 2.23e-10))) @ U.conj().T
        self.T = T
        self.H_array_w = np.einsum("bmn,bng->bmg", T, self.H_array)
        blocksize = 8 * hop if blocksize is None else blocksize
        assert blocksize % hop == 0
        self.blocksize = blocksize
        self.time_slots = blocksize // hop
        # hades_analysis_create:90-91 + the run-time 0.999 clamp at apply
        self.cov_avg_coeff = min(max(
            1.0 - 1.0 / (4096.0 / blocksize), 0.0), 0.99999)
        self.cov_avg_coeff = min(self.cov_avg_coeff, 0.999)
        self.diff_opt, self.doa_opt = diff_opt, doa_opt
        # device copies (RI)
        self._T_d = _split(self.T)
        self._Aw_d = _split(self.H_array_w)
        if self.n_mics == 2:
            # entrywise fast-path constants (bands on the lane axis): the
            # whitening matrix as four scalar complex entries, and the
            # sdMUSIC quadform folded into per-(band, grid) tables so
            # den = p00·|a0|² + p11·|a1|² + 2·Re(p01·conj(a0)a1) is pure
            # broadcast arithmetic — no (..., 2, 2) layouts anywhere
            import jax.numpy as jnp

            T = self.T
            self._T_e = tuple(tuple(
                (jnp.asarray(T[:, i, j].real.astype(np.float32)),
                 jnp.asarray(T[:, i, j].imag.astype(np.float32)))
                for j in (0, 1)) for i in (0, 1))
            a0 = self.H_array_w[:, 0]
            a1 = self.H_array_w[:, 1]
            z = a0.conj() * a1
            self._qf_d = (jnp.asarray((np.abs(a0) ** 2).astype(np.float32)),
                          jnp.asarray((np.abs(a1) ** 2).astype(np.float32)),
                          jnp.asarray(z.real.astype(np.float32)),
                          jnp.asarray(z.imag.astype(np.float32)))
        self.Cx_avg = (jnp.zeros((self.n_bands, self.n_mics, self.n_mics)),
                       jnp.zeros((self.n_bands, self.n_mics, self.n_mics)))
        self.bank_state = ri.init_state_ri(self.bank, self.n_mics, 2)

    @property
    def proc_delay(self) -> int:
        return self.bank.proc_delay

    def _cov_stats(self, Cx_avg):
        """Pure per-block spatial-parameter core: averaged SCM → (COMEDIE
        diffuseness, sdMUSIC DoA index).  Batched over all bands; vmapped
        over blocks by the fused pipeline."""
        import jax.numpy as jnp

        from spatial_audio_framework_tpu.ops import herm_ri as H

        # whiten: Cw = T Cx Tᴴ
        TC = H.cmatmul(self._T_d, Cx_avg)
        Th = (jnp.swapaxes(self._T_d[0], -1, -2),
              -jnp.swapaxes(self._T_d[1], -1, -2))
        Cw = H.cmatmul(TC, Th)
        # eigenvalues (descending) → COMEDIE; noise projector → sdMUSIC
        if self.n_mics == 2:
            # closed-form 2×2 path (binaural arrays): one sqrt instead of
            # the embedded 4×4 iterative eigh
            ev, V = H.herm_eig_2x2(Cw)          # descending
            vn = (V[0][..., 1:], V[1][..., 1:])  # smallest-λ eigenvector
            Pn = H.cmatmul(vn, H.chermitian(vn))
        else:
            ev, V = H.herm_eig_pairs(Cw)        # ascending (nBands, nMics)
            # Rayleigh-refined eigenvalues: COMEDIE consumes only λ, and the
            # quotient squares the f32 Jacobi vector error (C_PARITY: pulls
            # diffuseness to ~1e-4 of the C's LAPACK-cseig chain)
            ev = H.rayleigh_refine(Cw, V)[..., ::-1]
            Pn = H.noise_projector(Cw, 1)
        diff = comedie_batch(jnp.maximum(ev, 0.0))
        # sdMUSIC pseudo-spectrum: 1 / ‖Vnᴴ a‖² (hades_sdMUSIC_compute,
        # saf_hades_internal.c:196-204 — NO |a|² numerator, unlike sphMUSIC)
        den = H.herm_quadform(Pn, self._Aw_d)  # (nBands, nGrid)
        doa_idx = jnp.argmin(den, axis=-1)
        return diff, doa_idx

    def _cov_stats_e(self, C_e):
        """_cov_stats for the 2-mic path with the SCM in ENTRY form
        (((c00, c01), (c10, c11)) of (re, im) scalar arrays, bands last):
        whiten → closed-form eig → COMEDIE + sdMUSIC, all elementwise with
        the batch dims on the minor axis (see __init__'s _T_e/_qf_d)."""
        import jax.numpy as jnp

        from spatial_audio_framework_tpu.modules.cdf4sap import (
            _herm_eig_2x2_e, _m2_herm, _m2_mul)

        Cw = _m2_mul(_m2_mul(self._T_e, C_e), _m2_herm(self._T_e))
        l1, l2, V = _herm_eig_2x2_e(Cw[0][0][0], Cw[1][1][0], *Cw[0][1])
        diff = comedie_batch(jnp.stack([jnp.maximum(l1, 0.0),
                                        jnp.maximum(l2, 0.0)], -1))
        # noise projector from the smallest-λ eigenvector v (second row
        # real): Pn = v vᴴ → p00 = |v₀|², p11 = v₁², p01 = v₀·v₁
        (v2r0, v2i0) = V[0][1]
        v2r1 = V[1][1][0]
        p00 = v2r0 * v2r0 + v2i0 * v2i0
        p11 = v2r1 * v2r1
        p01r = v2r0 * v2r1
        p01i = v2i0 * v2r1
        A0, A1, zr, zi = self._qf_d
        den = (p00[..., None] * A0 + p11[..., None] * A1
               + 2.0 * (p01r[..., None] * zr - p01i[..., None] * zi))
        doa_idx = jnp.argmin(den, axis=-1)
        return diff, doa_idx

    def _step(self, bank_state, Cx_avg, x):
        """Jitted analysis core: one block, batched over all bands."""
        import jax
        import jax.numpy as jnp

        (sre, sim), bank_state = ri.analysis_ri(self.bank, bank_state, x)
        hp = _prec.HOT
        Cx_new = (jnp.einsum("bmh,bnh->bmn", sre, sre, precision=hp)
                  + jnp.einsum("bmh,bnh->bmn", sim, sim, precision=hp),
                  jnp.einsum("bmh,bnh->bmn", sim, sre, precision=hp)
                  - jnp.einsum("bmh,bnh->bmn", sre, sim, precision=hp))
        lam = self.cov_avg_coeff
        Cx_avg = (lam * Cx_avg[0] + (1 - lam) * Cx_new[0],
                  lam * Cx_avg[1] + (1 - lam) * Cx_new[1])
        diff, doa_idx = self._cov_stats(Cx_avg)
        return bank_state, Cx_avg, (sre, sim), Cx_new, diff, doa_idx

    def apply(self, x: np.ndarray):
        """x: (nMics, T) → (HadesParams, HadesSignals)."""
        import jax
        import jax.numpy as jnp

        if not hasattr(self, "_jit_step"):
            self._jit_step = jax.jit(self._step)
        bank_state, Cx_avg, inTF, Cx_new, diff, doa_idx = self._jit_step(
            self.bank_state, self.Cx_avg, jnp.asarray(x))
        self.bank_state, self.Cx_avg = bank_state, Cx_avg
        doa_idx = np.asarray(doa_idx)
        params = HadesParams(diffuseness=np.asarray(diff),
                             doa_idx=doa_idx, gains_idx=doa_idx.copy(),
                             gains_dir=np.ones(self.n_bands, np.float32),
                             gains_diff=np.ones(self.n_bands, np.float32))
        return params, HadesSignals(inTF=inTF, Cx=Cx_new)


class HadesRadialEditor:
    """hades_radial_editor (saf_hades_synthesis.h:96-115): per-direction gain
    pattern applied to the per-band direct/diffuse gains."""

    def __init__(self, grid_dirs_deg: np.ndarray):
        self.grid_dirs_deg = np.asarray(grid_dirs_deg)

    def apply(self, params: HadesParams, dir_gains_db: np.ndarray):
        """dir_gains_db: (360,) azimuth-dependent gains in dB.

        Mirrors hades_radial_editor_apply (saf_hades_synthesis.c:77-99)
        exactly: looks up the azimuth of ``gains_idx`` (== doa_idx after
        analysis), shifts -180..180 to 0..360, rounds half-up and clamps to
        [0, 359], clamps the dB edit to [-60, +12], and MULTIPLIES onto the
        existing per-band direct gains (edits accumulate)."""
        azi = self.grid_dirs_deg[params.gains_idx, 0].astype(np.float64)
        azi = np.where(azi < 0.0, azi + 360.0, azi)
        edit_idx = np.clip(np.floor(azi + 0.5).astype(int), 0, 359)
        g_db = np.clip(np.asarray(dir_gains_db, np.float64)[edit_idx],
                       -60.0, 12.0)
        params.gains_dir = (params.gains_dir *
                            (10.0 ** (g_db / 20.0))).astype(np.float32)
        return params


class HadesSynthesis:
    def __init__(self, ana: HadesAnalysis,
                 hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 beam_option: str = HADES_BEAMFORMER_FILTER_AND_SUM,
                 ref_indices=(0, 1), enable_cm: bool = True,
                 hrir_fs: float = 48000.0,
                 interp_option: str = HADES_HRTF_INTERP_TRIANGULAR):
        import jax.numpy as jnp

        self.ana = ana
        self.beam_option = beam_option
        self.ref = ref_indices
        self.enable_cm = enable_cm
        if hrirs is None:
            hrirs, hrir_dirs_deg, hrir_fs = hrir_mod.default_hrirs()
        hrirs = np.asarray(hrirs, np.float32)
        hrir_dirs_deg = np.asarray(hrir_dirs_deg, np.float64)
        # HRTFs through the SAME filterbank config, interpolated to the
        # analysis grid (hades_getInterpolatedHRTFs,
        # saf_hades_internal.c:42-114)
        H_fb = hrir_mod.hrirs_to_hrtfs_afstft(
            hrirs, ana.hop, low_delay=ana.bank.low_delay,
            hybrid=ana.bank.hybrid)
        # target-grid weights (identity/None for horizontal-only grids)
        if np.abs(ana.grid_dirs_deg[:, 1]).sum() / ana.n_grid < 1e-4:
            w_t = None
        else:
            w_t = geo.get_voronoi_weights(ana.grid_dirs_deg)
        if interp_option == HADES_HRTF_INTERP_NEAREST:
            from spatial_audio_framework_tpu.utils.sort import (
                find_closest_grid_points)

            idx = find_closest_grid_points(
                np.radians(hrir_dirs_deg), np.radians(ana.grid_dirs_deg))
            # quantise, then diffuse-field EQ without phase simplification
            self.H_bin = hrir_mod.diffuse_field_equalise_hrtfs(
                H_fb[:, :, idx], weights=w_t, apply_eq=True,
                apply_phase=False).astype(np.complex64)
        else:  # triangular (VBAP) interpolation
            from spatial_audio_framework_tpu.modules import vbap as _vbap

            itds = hrir_mod.estimate_itds(hrirs, hrir_fs)
            # df-EQ with phase simplification on the measurement grid.  (The
            # C passes the TARGET grid's Voronoi weights here, which only
            # aligns when nHRIR == nTargetDirs; we use the HRIR grid's own
            # weights — the sane reading of the same intent.)
            w_h = geo.get_voronoi_weights(hrir_dirs_deg)
            H_eq = hrir_mod.diffuse_field_equalise_hrtfs(
                H_fb, itds, ana.freq_vector, weights=w_h, apply_eq=True,
                apply_phase=True)
            gt = _vbap.generate_vbap_gain_table_3d_srcs(
                ana.grid_dirs_deg, hrir_dirs_deg)
            gt = _vbap.vbap_gain_table_to_interp_table(gt)
            self.H_bin = hrir_mod.interp_hrtfs(H_eq, gt, itds,
                                               ana.freq_vector)
        # binaural diffuse covariance + diffuse EQ (hades_synthesis_create:
        # H_bin W H_binᴴ / nGrid, diffEQ vs the ARRAY's reference-sensor
        # diffuse response, cap +9dB)
        DCM_bin = np.einsum("beg,g,bfg->bef", self.H_bin, ana.int_weights,
                            self.H_bin.conj()) / ana.n_grid
        r0, r1 = self.ref
        num = DCM_bin[:, 0, 0].real + DCM_bin[:, 1, 1].real
        den = (ana.DCM[:, r0, r0].real + ana.DCM[:, r1, r1].real + 2.23e-10)
        self.diff_eq = np.minimum(np.sqrt(num / den), 3.0)
        self.DCM_bin_norm = DCM_bin / (num + 2.23e-10)[:, None, None]
        self.eq = np.ones(ana.n_bands, np.float32)
        self.stream_balance = np.ones(ana.n_bands, np.float32)
        # hades_synthesis_create:~34 + the [0, 0.99] clamp at apply
        self.syn_avg_coeff = min(max(
            1.0 - 1.0 / (4096.0 / ana.blocksize), 0.0), 0.99)
        # device copies (RI)
        self._Hb_d = _split(self.H_bin)
        self._Ha_d = _split(ana.H_array)
        self._DCMn_d = _split(self.DCM_bin_norm)
        self._diff_eq_d = jnp.asarray(self.diff_eq.astype(np.float32))
        self.M = (jnp.zeros((ana.n_bands, 2, ana.n_mics)),
                  jnp.zeros((ana.n_bands, 2, ana.n_mics)))
        self.bank_state = ri.init_state_ri(ana.bank, ana.n_mics, 2)

    def _mix_mtx(self, Cx, diffuseness, doa_idx, gains_idx, gains_dir,
                 gains_diff, eq, stream_balance):
        """Pure per-block mixing-matrix core (saf_hades_synthesis.c:308-460,
        up to but excluding the temporal smoothing): → Mb (nBands, 2, nMics)
        complex pair.  Batched over all bands; vmapped over blocks by the
        fused pipeline."""
        import jax
        import jax.numpy as jnp

        from spatial_audio_framework_tpu.ops import herm_ri as H

        ana = self.ana
        n_mics, n_bands = ana.n_mics, ana.n_bands
        r0, r1 = self.ref
        psi = jnp.clip(diffuseness, 0.0, 1.0)
        bal = jnp.clip(stream_balance, 0.0, 2.0)
        a = jnp.minimum(bal, 1.0) * gains_dir
        bb = jnp.minimum(2.0 - bal, 1.0) * gains_diff

        # steering at the estimated DoA + HRTF at the (editable) gain index
        def take_g(A, idx):
            return (jnp.take_along_axis(A[0], idx[:, None, None], 2)[..., 0],
                    jnp.take_along_axis(A[1], idx[:, None, None], 2)[..., 0])

        As = take_g(self._Ha_d, doa_idx)         # (nBands, nMics)
        h_dir = take_g(self._Hb_d, gains_idx)    # (nBands, 2)
        As_r0 = (As[0][:, r0:r0 + 1] + 1e-12, As[1][:, r0:r0 + 1])
        As_r1 = (As[0][:, r1:r1 + 1] + 1e-12, As[1][:, r1:r1 + 1])
        As_l = H.cdiv(As, As_r0)
        As_r = H.cdiv(As, As_r1)
        g_l = H.cdiv((h_dir[0][:, 0], h_dir[1][:, 0]),
                     (As_r0[0][:, 0], As_r0[1][:, 0]))
        g_r = H.cdiv((h_dir[0][:, 1], h_dir[1][:, 1]),
                     (As_r1[0][:, 0], As_r1[1][:, 0]))
        # |g|>4 guard (hades_synthesis.c): both fall back to 1
        bad = ((H.cabs2(g_l) > 16.0) | (H.cabs2(g_r) > 16.0))
        g_l = (jnp.where(bad, 1.0, g_l[0]), jnp.where(bad, 0.0, g_l[1]))
        g_r = (jnp.where(bad, 1.0, g_r[0]), jnp.where(bad, 0.0, g_r[1]))

        onehot0 = jax.nn.one_hot(r0, n_mics)
        onehot1 = jax.nn.one_hot(r1, n_mics)
        Q_diff = (jnp.stack([onehot0, onehot1])[None]
                  * self._diff_eq_d[:, None, None],
                  jnp.zeros((n_bands, 2, n_mics)))

        if self.beam_option == HADES_BEAMFORMER_NONE:
            Q = (jnp.broadcast_to(jnp.stack([onehot0, onehot1]),
                                  (n_bands, 2, n_mics)),
                 jnp.zeros((n_bands, 2, n_mics)))
        else:
            if self.beam_option == HADES_BEAMFORMER_FILTER_AND_SUM:
                # pinv of a column vector: conj(v)/‖v‖²
                def fas_row(Asx, g):
                    n2 = H.cabs2(Asx).sum(-1, keepdims=True) + 1e-12
                    row = (Asx[0] / n2, -Asx[1] / n2)
                    return H.cmul(row, (g[0][:, None], g[1][:, None]))

                rl = fas_row(As_l, g_l)
                rr = fas_row(As_r, g_r)
                Q_dir = (jnp.stack([rl[0], rr[0]], 1),
                         jnp.stack([rl[1], rr[1]], 1))
            else:  # BMVDR
                tr = jnp.einsum("bmm->b", Cx[0])
                load = (tr / n_mics * 10.0 + 1e-4)[:, None, None] \
                    * jnp.eye(n_mics)
                Cx_l = (Cx[0] + load, Cx[1])

                # w = Cx⁻¹ conj(As) exactly as the C's utility_cglslv (f32
                # LAPACK cgesv op-order; saf_hades_synthesis.c:411) — the
                # e2e parity floor was the C's own cgesv noise.  Both ears
                # share one factorization (the C's two cglslv calls LU the
                # identical matrix; per-RHS ops are independent).
                wv2 = H.cgesv_ri(
                    Cx_l, (jnp.stack([As_l[0], As_r[0]], -1),
                           jnp.stack([-As_l[1], -As_r[1]], -1)))

                def bmvdr_row(wv, Asx, g):
                    den = (jnp.einsum("bm,bm->b", wv[0], Asx[0])
                           - jnp.einsum("bm,bm->b", wv[1], Asx[1]) + 1e-5,
                           jnp.einsum("bm,bm->b", wv[0], Asx[1])
                           + jnp.einsum("bm,bm->b", wv[1], Asx[0]))
                    # the C computes 1/den once (ccdivf = __divsc3, Smith
                    # division) then cscal-multiplies it through
                    rr, ri = H._sladiv(jnp.ones_like(den[0]),
                                       jnp.zeros_like(den[0]),
                                       den[0], den[1])
                    row = H.cmul(wv, (rr[:, None], ri[:, None]))
                    return H.cmul(row, (g[0][:, None], g[1][:, None]))

                rl = bmvdr_row((wv2[0][..., 0], wv2[1][..., 0]), As_l, g_l)
                rr = bmvdr_row((wv2[0][..., 1], wv2[1][..., 1]), As_r, g_r)
                Q_dir = (jnp.stack([rl[0], rr[0]], 1),
                         jnp.stack([rl[1], rr[1]], 1))
                # the C's check is cblas_scasum = sum(|re|+|im|), not the
                # sum of magnitudes (saf_hades_synthesis.c:396)
                dead = ((tr < 1e-4)
                        | ((jnp.abs(As[0]) + jnp.abs(As[1])).sum(-1) < 1e-4))
                Q_dir = (jnp.where(dead[:, None, None], 0.0, Q_dir[0]),
                         jnp.where(dead[:, None, None], 0.0, Q_dir[1]))
            wd = (eq * a * (1.0 - psi))[:, None, None]
            wf = (eq * bb * psi)[:, None, None]
            Q = (wd * Q_dir[0] + wf * Q_diff[0],
                 wd * Q_dir[1] + wf * Q_diff[1])

        # covariance matching (saf_hades_synthesis.c:430-460)
        target_e = eq * 0.25 * jnp.einsum("bmm->b", Cx[0]) * self._diff_eq_d
        if self.enable_cm:
            wdir = (eq * a * (1 - psi) * target_e)[:, None, None]
            wdif = (eq * bb * psi * target_e)[:, None, None]
            hh = (jnp.einsum("be,bf->bef", h_dir[0], h_dir[0])
                  + jnp.einsum("be,bf->bef", h_dir[1], h_dir[1]),
                  jnp.einsum("be,bf->bef", h_dir[1], h_dir[0])
                  - jnp.einsum("be,bf->bef", h_dir[0], h_dir[1]))
            Cy = (wdir * hh[0] + wdif * self._DCMn_d[0],
                  wdir * hh[1] + wdif * self._DCMn_d[1])
            Mb = cdf4sap.formulate_M_and_Cr_ri(Cx, Cy, Q, True, 0.1)[0]
            use = (target_e > 1e-4)[:, None, None]
            Mb = (jnp.where(use, Mb[0], Q[0]), jnp.where(use, Mb[1], Q[1]))
        else:
            Mb = Q
        return Mb

    def _step(self, M, bank_state, inTF, Cx, diffuseness, doa_idx, gains_idx,
              gains_dir, gains_diff, eq, stream_balance):
        """Jitted synthesis core, batched over all bands
        (saf_hades_synthesis.c:308-470)."""
        from spatial_audio_framework_tpu.ops import herm_ri as H

        ana = self.ana
        Mb = self._mix_mtx(Cx, diffuseness, doa_idx, gains_idx, gains_dir,
                           gains_diff, eq, stream_balance)
        c = self.syn_avg_coeff
        M = (c * M[0] + (1 - c) * eq[:, None, None] * Mb[0],
             c * M[1] + (1 - c) * eq[:, None, None] * Mb[1])
        out = H.ceinsum("bem,bmh->beh", M, inTF)
        y, bank_state = ri.synthesis_ri(ana.bank, bank_state, out)
        return M, bank_state, y

    def apply(self, params: HadesParams, sigs: HadesSignals) -> np.ndarray:
        """→ binaural output block (2, T)."""
        import jax
        import jax.numpy as jnp

        if not hasattr(self, "_jit_step"):
            self._jit_step = jax.jit(self._step)
        M, bank_state, y = self._jit_step(
            self.M, self.bank_state, sigs.inTF, sigs.Cx,
            jnp.asarray(params.diffuseness),
            jnp.asarray(params.doa_idx), jnp.asarray(params.gains_idx),
            jnp.asarray(params.gains_dir), jnp.asarray(params.gains_diff),
            jnp.asarray(self.eq.astype(np.float32)),
            jnp.asarray(self.stream_balance.astype(np.float32)))
        self.M, self.bank_state = M, bank_state
        return np.asarray(y)


# ---------------------------------------------------------------------------
# Fused device pipeline (fast path)
# ---------------------------------------------------------------------------

class HadesPipeline:
    """Analysis + synthesis fused into ONE jitted dispatch per block, with
    the spatial parameters (diffuseness, DoA indices) staying on device —
    the separate :meth:`HadesAnalysis.apply` / :meth:`HadesSynthesis.apply`
    path reads the parameter container back to host every block (two
    dispatch round-trips + a d2h fence), which on a remote-attached device
    is latency-bound.  The fused path exists for deployments that do not
    edit the parameter stream between analysis and synthesis (no
    HadesRadialEditor); both paths share the same traced cores, so outputs
    are identical.

    Also exposes :meth:`process_chunk`, which scans a whole multi-block
    chunk on device (one dispatch for many blocks).
    """

    def __init__(self, ana: HadesAnalysis, syn: HadesSynthesis):
        import jax
        import jax.numpy as jnp

        assert syn.ana is ana
        self.ana, self.syn = ana, syn
        ones = jnp.ones(ana.n_bands, jnp.float32)

        def block_eq(state, x, eq, bal):
            ana_bank, cx_avg, M, syn_bank = state
            ana_bank, cx_avg, inTF, Cx_new, diff, doa_idx = ana._step(
                ana_bank, cx_avg, x)
            M, syn_bank, y = syn._step(
                M, syn_bank, inTF, Cx_new, diff, doa_idx, doa_idx,
                ones, ones, eq, bal)
            return (ana_bank, cx_avg, M, syn_bank), y

        # traced eq/stream-balance: runtime edits to syn.eq /
        # syn.stream_balance are picked up per call, as in the two-stage path
        self._jit_block = jax.jit(block_eq)

        def chunk_scan(state, x_blocks, eq, bal):
            return jax.lax.scan(
                lambda c, xb: block_eq(c, xb, eq, bal), state, x_blocks)

        self._jit_chunk_scan = jax.jit(chunk_scan)

        # y[t] = lam·y[t-1] + (1-lam)·u[t] as one lower-triangular matmul
        # (shared with spreader.process_chunk)
        from spatial_audio_framework_tpu.ops.iir import (
            onepole_ewma_mats as onepole_kernel)

        def chunk(state, x_blocks, eq, bal):
            """All blocks of a chunk in ONE batched graph — no scan.

            The only sequential couplings across blocks are (a) the afSTFT
            states, handled by running analysis/synthesis once over the
            concatenated chunk (streaming filterbanks: a long call equals
            consecutive short calls), and (b) two one-pole recurrences (SCM
            averaging, mixing-matrix smoothing), which are LINEAR — so each
            becomes a single (nBlocks × nBlocks) lower-triangular matmul
            against precomputed decay weights instead of a length-nBlocks
            lax.scan.  Every per-band op then carries a leading block axis
            (vmap of the same traced cores ⇒ numerics match the scan path up
            to the recurrences' summation order).  This is what moves HADES
            from ~112× to chip-limited throughput: the scan serialised ~16
            tiny-op chains per chunk; here the chain length is 1."""
            from spatial_audio_framework_tpu.ops import herm_ri as H

            ana_bank, cx0, M0, syn_bank = state
            nb = x_blocks.shape[0]
            nm, bs, ts = ana.n_mics, ana.blocksize, ana.time_slots
            hp = _prec.HOT
            x_cat = jnp.swapaxes(x_blocks, 0, 1).reshape(nm, nb * bs)
            (sre, sim), ana_bank = ri.analysis_ri(ana.bank, ana_bank, x_cat)

            def to_blocks(s):  # (B, M, nb*ts) → (nb, B, M, ts)
                B, Mch, _ = s.shape
                return jnp.moveaxis(s.reshape(B, Mch, nb, ts), 2, 0)

            inTF = (to_blocks(sre), to_blocks(sim))
            Lc, pc = onepole_kernel(ana.cov_avg_coeff, nb)
            if ana.n_mics == 2:
                # entrywise 2-mic path: the SCM's three unique entries as
                # scalar (t, nBands) arrays (bands on lanes) — no
                # (..., 2, 2) stacking until the synthesis boundary
                r0, r1 = inTF[0][:, :, 0], inTF[0][:, :, 1]
                i0, i1 = inTF[1][:, :, 0], inTF[1][:, :, 1]
                c00 = (r0 * r0 + i0 * i0).sum(-1)
                c11 = (r1 * r1 + i1 * i1).sum(-1)
                c01r = (r0 * r1 + i0 * i1).sum(-1)
                c01i = (i0 * r1 - r0 * i1).sum(-1)

                def rec(e, e0):
                    return (jnp.einsum("tk,kb->tb", Lc, e, precision=hp)
                            + pc[:, None] * e0)

                a00 = rec(c00, cx0[0][:, 0, 0])
                a11 = rec(c11, cx0[0][:, 1, 1])
                a01r = rec(c01r, cx0[0][:, 0, 1])
                a01i = rec(c01i, cx0[1][:, 0, 1])
                z = jnp.zeros_like(a00)
                C_e = (((a00, z), (a01r, a01i)),
                       ((a01r, -a01i), (a11, z)))
                diff, doa_idx = ana._cov_stats_e(C_e)
                # stacked forms only where consumers need them: Cx_new for
                # the BMVDR/CM synthesis, Cx_avg[-1] for the state carry
                Cx_new = (
                    jnp.stack([jnp.stack([c00, c01r], -1),
                               jnp.stack([c01r, c11], -1)], -2),
                    jnp.stack([jnp.stack([jnp.zeros_like(c00), c01i], -1),
                               jnp.stack([-c01i, jnp.zeros_like(c00)], -1)],
                              -2))
                Cx_avg = (
                    jnp.stack([jnp.stack([a00, a01r], -1),
                               jnp.stack([a01r, a11], -1)], -2),
                    jnp.stack([jnp.stack([z, a01i], -1),
                               jnp.stack([-a01i, z], -1)], -2))
            else:
                Cx_new = (jnp.einsum("tbmh,tbnh->tbmn", inTF[0], inTF[0],
                                     precision=hp)
                          + jnp.einsum("tbmh,tbnh->tbmn", inTF[1], inTF[1],
                                       precision=hp),
                          jnp.einsum("tbmh,tbnh->tbmn", inTF[1], inTF[0],
                                     precision=hp)
                          - jnp.einsum("tbmh,tbnh->tbmn", inTF[0], inTF[1],
                                       precision=hp))
                Cx_avg = tuple(
                    jnp.einsum("tk,kbmn->tbmn", Lc, Cn, precision=hp)
                    + pc[:, None, None, None] * c0
                    for Cn, c0 in zip(Cx_new, cx0))
                diff, doa_idx = jax.vmap(ana._cov_stats)(Cx_avg)

            ones_b = jnp.ones(ana.n_bands, jnp.float32)
            Mb = jax.vmap(lambda cx, d, di: syn._mix_mtx(
                cx, d, di, di, ones_b, ones_b, eq, bal))(Cx_new, diff,
                                                         doa_idx)
            Lm, pm = onepole_kernel(syn.syn_avg_coeff, nb)
            M_t = tuple(
                jnp.einsum("tk,kbem->tbem", Lm,
                           eq[None, :, None, None] * mb, precision=hp)
                + pm[:, None, None, None] * m0
                for mb, m0 in zip(Mb, M0))
            out = H.ceinsum("tbem,tbmh->tbeh", M_t, inTF)
            out_cat = tuple(
                jnp.moveaxis(o, 0, 2).reshape(ana.n_bands, 2, nb * ts)
                for o in out)
            y_cat, syn_bank = ri.synthesis_ri(ana.bank, syn_bank, out_cat)
            ys = jnp.swapaxes(y_cat.reshape(2, nb, bs), 0, 1)
            state = (ana_bank,
                     tuple(c[-1] for c in Cx_avg),
                     tuple(m[-1] for m in M_t),
                     syn_bank)
            return state, ys

        self._jit_chunk = jax.jit(chunk)
        # multi-instance fast path: N independent HADES instances (e.g. N
        # concurrent hearing-device streams) rendered in ONE dispatch.  The
        # per-band matrices are tiny (133×2×2); a single instance leaves the
        # chip idle and the dispatch dominated by per-op overhead, so the
        # instance axis is vmapped straight through the fused chunk — every
        # eigh/solve/CDF4SAP op becomes (N, nBlocks, 133, 2, 2) batched
        # linear algebra at essentially the single-instance op count.
        self._chunk_fn = chunk
        self._jit_chunk_batched = jax.jit(
            jax.vmap(chunk, in_axes=(0, 0, None, None)))

    def _controls(self):
        import jax.numpy as jnp

        return (jnp.asarray(np.asarray(self.syn.eq, np.float32)),
                jnp.asarray(np.asarray(self.syn.stream_balance, np.float32)))

    def init_state(self):
        return (self.ana.bank_state, self.ana.Cx_avg, self.syn.M,
                self.syn.bank_state)

    def process(self, state, x):
        """One block: x (nMics, blocksize) → ((2, blocksize), state)."""
        state, y = self._jit_block(state, x, *self._controls())
        return y, state

    def process_chunk(self, state, x_blocks):
        """Many blocks in one dispatch: x_blocks (nBlocks, nMics, blocksize)
        → ((nBlocks, 2, blocksize), state)."""
        state, ys = self._jit_chunk(state, x_blocks, *self._controls())
        return ys, state

    def init_state_batched(self, n_instances: int):
        """Independent state for ``n_instances`` concurrent instances."""
        import jax
        import jax.numpy as jnp

        return jax.tree_util.tree_map(
            lambda a: jnp.zeros((n_instances,) + a.shape, a.dtype),
            self.init_state())

    def process_chunk_batched(self, state, x_blocks):
        """N instances × many blocks in ONE dispatch:
        x_blocks (N, nBlocks, nMics, blocksize)
        → ((N, nBlocks, 2, blocksize), state).  Numerics identical to N
        separate :meth:`process_chunk` calls (vmap of the same traced core);
        shared eq/stream-balance controls across instances."""
        state, ys = self._jit_chunk_batched(state, x_blocks,
                                            *self._controls())
        return ys, state
