"""spreader — coherent/incoherent source spreading over arbitrary IR sets
(counterpart of ``examples/src/spreader``).

Modes (spreader.h SPREADER_MODE_*): 'naive' (coherent sum of the IR-set
responses within the spread area), 'evd' (eigen-decomposition mixing of
decorrelated replicas to hit the target covariance), and 'om' (CDF4SAP
optimal-mixing of the prototype signals + decorrelated residual).

Design: the spread-area selection is a traced mask over the IR grid
(angles ≤ spread/2), so source directions/spreads stream per block; target
covariances (Σ h hᴴ over the area), the CDF4SAP solves and the EVD run
batched over all 133 bands at once.  The entire chain runs in split
real/imaginary arithmetic (ops.afstft_ri, ops.herm_ri,
cdf4sap.formulate_M_and_Cr_ri) — no complex64 reaches the device graph.
Default IR set: the default HRIRs
(Q = 2, binaural spreading), as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.modules import cdf4sap, hrir as hrir_mod
from spatial_audio_framework_tpu.ops import afstft_ri as ri, herm_ri as H
from spatial_audio_framework_tpu.ops.afstft import AfSTFT
from spatial_audio_framework_tpu.utils import decor
from spatial_audio_framework_tpu.utils.geometry import unit_sph2cart
from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops import precision as _prec

MODE_NAIVE = "naive"
MODE_EVD = "evd"
MODE_OM = "om"
MAX_SPREAD_FREQ = 16e3  # spreader_internal.h


@dataclass(frozen=True)
class SpreaderConfig:
    n_sources: int = 1
    fs: float = 48000.0
    mode: str = MODE_OM
    cov_avg_coeff: float = 0.8
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class SpreaderWeights(NamedTuple):
    H_re: jax.Array      # (nBands, Q, nGrid) IR-set responses (re)
    H_im: jax.Array
    HHH_re: jax.Array    # (nBands, nGrid, Q, Q) outer products h hᴴ
    HHH_im: jax.Array
    grid_u: jax.Array    # (nGrid, 3)
    freqs: jax.Array
    lattice: dict        # decorrelator design


class SpreaderState(NamedTuple):
    bank: ri.AfSTFTStateRI
    lattice: tuple                 # per-source decorrelator states (RI)
    Cproto_re: jax.Array           # (nSrc, nBands, Q, Q)
    Cproto_im: jax.Array
    Cy_re: jax.Array
    Cy_im: jax.Array
    prev_M_re: jax.Array           # (nSrc, nBands, Q, Q)
    prev_M_im: jax.Array
    prev_Mr: jax.Array             # (nSrc, nBands, Q, Q) real


def _lat(cfg: SpreaderConfig, n_ch: int) -> decor.LatticeDecorrelator:
    # spreader.c:263-266: orders {20,15,6,6}, cutoffs {900, 6.8k, 12k, 24k},
    # maxDelay 12, enComp 0.75
    return decor.LatticeDecorrelator(
        fs=cfg.fs, hop_size=cfg.hop, n_ch=n_ch,
        orders=(20, 15, 6, 6), freq_cutoffs=(900.0, 6.8e3, 12e3, 24e3),
        max_delay=12, en_comp_coeff=0.75)


def design(cfg: SpreaderConfig, irs: Optional[np.ndarray] = None,
           ir_dirs_deg: Optional[np.ndarray] = None,
           ir_fs: Optional[int] = None,
           c_rand_offset: int = None) -> SpreaderWeights:
    """``c_rand_offset``: glibc rand() stream position of the C process at
    its first latticeDecorrelator_create — the source-0 decorrelation delays
    then match the reference bit-exactly (see models/decorrelator.design)."""
    if irs is None:
        irs, ir_dirs_deg, ir_fs = hrir_mod.default_hrirs()
    if ir_fs != cfg.fs:
        irs, _ = hrir_mod.resample_hrirs(irs, ir_fs, int(cfg.fs))
    Hf = hrir_mod.hrirs_to_hrtfs_afstft(irs, cfg.hop)  # (nBands, Q, nGrid)
    # outer products carry the grid's Voronoi weights / 4π
    # (spreader.c:276-289: getVoronoiWeights → sscal 1/FOURPI → cscal HHH)
    from spatial_audio_framework_tpu.utils import geometry as _geo

    w_g = _geo.get_voronoi_weights(np.asarray(ir_dirs_deg, np.float64))
    w_g = np.asarray(w_g, np.float64) / (4.0 * np.pi)
    HHH = np.einsum("bqg,g,brg->bgqr", Hf, w_g, Hf.conj())
    u = np.asarray(unit_sph2cart(np.asarray(ir_dirs_deg, np.float64),
                                 degrees=True), np.float32)
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    return SpreaderWeights(
        H_re=jnp.asarray(Hf.real.astype(np.float32)),
        H_im=jnp.asarray(Hf.imag.astype(np.float32)),
        HHH_re=jnp.asarray(HHH.real.astype(np.float32)),
        HHH_im=jnp.asarray(HHH.imag.astype(np.float32)),
        grid_u=jnp.asarray(u), freqs=jnp.asarray(freqs),
        lattice=_lat(cfg, irs.shape[1]).design(
            freqs, c_rand_stream=_c_stream(c_rand_offset)))


def _c_stream(offset):
    if offset is None:
        return None
    from spatial_audio_framework_tpu.utils.convhull3d import glibc_rand_at

    return glibc_rand_at(offset)


def init_state(cfg: SpreaderConfig, w: SpreaderWeights) -> SpreaderState:
    Q = w.H_re.shape[1]
    n_bands = cfg.afstft.n_bands
    lat = _lat(cfg, Q)
    eye = jnp.broadcast_to(jnp.eye(Q, dtype=jnp.float32),
                           (cfg.n_sources, n_bands, Q, Q))
    z = jnp.zeros((cfg.n_sources, n_bands, Q, Q), jnp.float32)
    return SpreaderState(
        bank=ri.init_state_ri(cfg.afstft, cfg.n_sources, Q),
        lattice=tuple(decor.lattice_init_state_ri(lat, w.lattice, n_bands)
                      for _ in range(cfg.n_sources)),
        Cproto_re=z, Cproto_im=z, Cy_re=z, Cy_im=z,
        prev_M_re=eye, prev_M_im=z, prev_Mr=z)


def _spread_statics(w: SpreaderWeights, src_dir_deg: jax.Array,
                    spread_deg: jax.Array, below: jax.Array):
    """Per-source quantities that depend only on (direction, spread):
    the spread-area response average h_avg, the target covariance Cy_st and
    the centre-direction response h_c.  Shared by :func:`process` and
    :func:`process_chunk`; unused outputs are dead-code-eliminated under
    jit (e.g. Cy_st in naive mode).

    Cy_st mirrors an upstream quirk exactly (docs/C_PARITY.md bug #8): the
    C's per-band accumulator Cy is only memset INSIDE the
    freq < MAX_SPREAD_FREQ branch (spreader.c:485-503); above it, the
    nSpread==0 fallback cblas_caxpy of the centre direction's HHH lands ON
    TOP of the last below-band spread-area sum and keeps accumulating
    across all higher bands — hence the cumsum over the above-band mask.
    EVD mode's global Gcomp normalisation sums traces over ALL bands, so
    the quirk is audible there."""
    u_src = jnp.asarray(unit_sph2cart(src_dir_deg, degrees=True))
    cosang = jnp.clip(w.grid_u @ u_src, -1.0, 0.9999999)
    angles = jnp.degrees(jnp.arccos(cosang))
    centre = jnp.argmin(angles)
    in_area = (angles <= spread_deg / 2.0)
    use_area = (in_area.sum() > 0)
    oh = jax.nn.one_hot(centre, angles.shape[0])
    area_mask = jnp.where(use_area, in_area.astype(jnp.float32), oh)
    mask = jnp.where(below[:, None], area_mask[None, :], oh[None, :])
    n_eff = jnp.maximum(mask.sum(-1), 1.0)
    H_sum = (jnp.einsum("bqg,bg->bq", w.H_re, mask),
             jnp.einsum("bqg,bg->bq", w.H_im, mask))
    h_avg = (H_sum[0] / n_eff[:, None], H_sum[1] / n_eff[:, None])
    S = (jnp.einsum("bgqr,g->bqr", w.HHH_re, area_mask),
         jnp.einsum("bgqr,g->bqr", w.HHH_im, area_mask))
    ch = (jnp.take(w.HHH_re, centre, axis=1),
          jnp.take(w.HHH_im, centre, axis=1))          # (nBands, Q, Q)
    above = (~below)[:, None, None]
    cs = (jnp.cumsum(ch[0] * above, axis=0),
          jnp.cumsum(ch[1] * above, axis=0))
    k0m1 = below.sum() - 1                             # last below band
    base = (jnp.take(S[0], k0m1, axis=0), jnp.take(S[1], k0m1, axis=0))
    bel3 = below[:, None, None]
    Cy_st = (jnp.where(bel3, S[0], base[0][None] + cs[0]),
             jnp.where(bel3, S[1], base[1][None] + cs[1]))
    h_c = (jnp.take(w.H_re, centre, axis=2),
           jnp.take(w.H_im, centre, axis=2))           # (nBands, Q)
    return h_avg, Cy_st, h_c


def process(cfg: SpreaderConfig, w: SpreaderWeights, state: SpreaderState,
            x: jax.Array, src_dirs_deg: jax.Array, src_spread_deg: jax.Array):
    """x: (nSrc, T) → ((Q, T), state).  Complex-free throughout."""
    bank = cfg.afstft
    Q = w.H_re.shape[1]
    (sre, sim), bank_st = ri.analysis_ri(bank, state.bank, x)
    H_slots = sre.shape[-1]
    lam = cfg.cov_avg_coeff
    lat = _lat(cfg, Q)
    Hg = (w.H_re, w.H_im)
    HHH = (w.HHH_re, w.HHH_im)

    out = (jnp.zeros((bank.n_bands, Q, H_slots), jnp.float32),
           jnp.zeros((bank.n_bands, Q, H_slots), jnp.float32))
    new_lat, new_Cp, new_Cy, new_M, new_Mr = [], [], [], [], []
    fade_in = jnp.arange(1, H_slots + 1, dtype=jnp.float32) / H_slots
    below = (w.freqs < MAX_SPREAD_FREQ)

    for src in range(cfg.n_sources):
        spec_s = (sre[:, src], sim[:, src])                # (nBands, H)
        h_avg, Cy_st, h_c = _spread_statics(w, src_dirs_deg[src],
                                            src_spread_deg[src], below)
        proto = (h_avg[0][:, :, None] * spec_s[0][:, None, :]
                 - h_avg[1][:, :, None] * spec_s[1][:, None, :],
                 h_avg[0][:, :, None] * spec_s[1][:, None, :]
                 + h_avg[1][:, :, None] * spec_s[0][:, None, :])

        if cfg.mode == MODE_NAIVE:
            out = (out[0] + proto[0], out[1] + proto[1])
            new_lat.append(state.lattice[src])
            new_Cp.append((state.Cproto_re[src], state.Cproto_im[src]))
            new_Cy.append((state.Cy_re[src], state.Cy_im[src]))
            new_M.append((state.prev_M_re[src], state.prev_M_im[src]))
            new_Mr.append(state.prev_Mr[src])
            continue

        if cfg.mode == MODE_EVD:
            proto = (jnp.broadcast_to(spec_s[0][:, None, :],
                                      (bank.n_bands, Q, H_slots)),
                     jnp.broadcast_to(spec_s[1][:, None, :],
                                      (bank.n_bands, Q, H_slots)))
        dec, lat_st = decor.lattice_apply_ri(lat, w.lattice,
                                             state.lattice[src],
                                             proto[0], proto[1])
        Cp_new = H.ceinsum("bqh,brh->bqr", proto, H.conj(proto))
        Cp = (lam * state.Cproto_re[src] + (1 - lam) * Cp_new[0],
              lam * state.Cproto_im[src] + (1 - lam) * Cp_new[1])
        # target covariance (incl. the above-band accumulator quirk, see
        # _spread_statics)
        Cy_new = Cy_st
        bel3 = below[:, None, None]
        if cfg.mode == MODE_OM:
            # impose target energies (spreader.c:#if 1 block)
            tr_y = jnp.einsum("bqq->b", Cy_new[0])
            sig_c = (h_c[0][:, :, None] * spec_s[0][:, None, :]
                     - h_c[1][:, :, None] * spec_s[1][:, None, :],
                     h_c[0][:, :, None] * spec_s[1][:, None, :]
                     + h_c[1][:, :, None] * spec_s[0][:, None, :])
            tr_e = jnp.einsum("bqh,bqh->b", sig_c[0], sig_c[0]) \
                + jnp.einsum("bqh,bqh->b", sig_c[1], sig_c[1])
            scale = jnp.where(below, tr_e / (tr_y + 2.23e-9), 1.0)
            Cy_new = (Cy_new[0] * scale[:, None, None],
                      Cy_new[1] * scale[:, None, None])
        Cy = (lam * state.Cy_re[src] + (1 - lam) * Cy_new[0],
              lam * state.Cy_im[src] + (1 - lam) * Cy_new[1])

        if cfg.mode == MODE_EVD:
            e_y = jnp.einsum("bqq->", Cy[0])
            # the C adds 1e-6 PER (band, channel) diagonal term
            # (spreader.c:552: Eproto += ... + 0.000001f inside the loop)
            e_p = (jnp.einsum("bqq->", Cp[0])
                   + 1e-6 * (Cp[0].shape[0] * Cp[0].shape[1]))
            # Gcomp = sqrt(Eproto/Ey) (spreader.c:524) — the C scales the
            # target covariance by the SQRT of the energy ratio
            s = jnp.sqrt(e_p / (e_y + 2.23e-9))
            if Q == 2:
                # bit-faithful utility_cseig (sortDecFLAG=1): LAPACK cheev's
                # exact eigenvector signs/phases — M mixes DECORRELATED
                # channels, whose mutual correlations make the output depend
                # on the vector phases, not just the subspaces
                lam_e, V = H.cheev_2x2((Cy[0] * s, Cy[1] * s))
            else:
                lam_e, V = H.herm_eig_pairs((Cy[0] * s, Cy[1] * s))
                lam_e = lam_e[..., ::-1]
                V = (V[0][..., ::-1], V[1][..., ::-1])
            root = jnp.sqrt(jnp.maximum(lam_e, 0.0))[..., None, :]
            M = (V[0] * root, V[1] * root)
            Mr = jnp.zeros_like(state.prev_Mr[src])
            sig_in = dec
        else:  # OM
            eyeQ = jnp.eye(Q, dtype=jnp.float32)
            Cp_l = (Cp[0] + 1e-5 * eyeQ, Cp[1])
            Qid = (jnp.broadcast_to(eyeQ, Cp[0].shape), jnp.zeros_like(Cp[0]))
            M, Cr = cdf4sap.formulate_M_and_Cr_ri(Cp_l, Cy, Qid, False, 0.2)
            Cp_diag = jnp.einsum("bqq->bq", Cp[0])[..., None] * eyeQ
            # real residual-mixing solve routed through the entrywise 2×2
            # complex path with zero imaginary parts — the generic real path
            # lowers to three batched Jacobi SVDs per frame
            zz = jnp.zeros_like(Cp_diag)
            Mr = cdf4sap.formulate_M_and_Cr_ri(
                (Cp_diag, zz), (Cr[0], zz), Qid, False, 0.2)[0][0]
            M = (jnp.where(below[:, None, None], M[0], eyeQ[None]),
                 jnp.where(below[:, None, None], M[1], 0.0))
            Mr = jnp.where(below[:, None, None], Mr, 0.0)
            sig_in = proto

        # crossfaded mixing-matrix application (spreader.c interpolator)
        f = fade_in[None, :, None, None]
        M_t = (f * M[0][:, None] + (1 - f) * state.prev_M_re[src][:, None],
               f * M[1][:, None] + (1 - f) * state.prev_M_im[src][:, None])
        mixed = (jnp.einsum("bhqr,brh->bqh", M_t[0], sig_in[0])
                 - jnp.einsum("bhqr,brh->bqh", M_t[1], sig_in[1]),
                 jnp.einsum("bhqr,brh->bqh", M_t[0], sig_in[1])
                 + jnp.einsum("bhqr,brh->bqh", M_t[1], sig_in[0]))
        if cfg.mode == MODE_OM:
            Mr_t = f * Mr[:, None] + (1 - f) * state.prev_Mr[src][:, None]
            mixed = (mixed[0] + jnp.einsum("bhqr,brh->bqh", Mr_t, dec[0]),
                     mixed[1] + jnp.einsum("bhqr,brh->bqh", Mr_t, dec[1]))
        out = (out[0] + mixed[0], out[1] + mixed[1])
        new_lat.append(lat_st)
        new_Cp.append(Cp); new_Cy.append(Cy)
        new_M.append(M); new_Mr.append(Mr)

    y, bank_st = ri.synthesis_ri(bank, bank_st, out)
    new_state = SpreaderState(
        bank=bank_st, lattice=tuple(new_lat),
        Cproto_re=jnp.stack([c[0] for c in new_Cp]),
        Cproto_im=jnp.stack([c[1] for c in new_Cp]),
        Cy_re=jnp.stack([c[0] for c in new_Cy]),
        Cy_im=jnp.stack([c[1] for c in new_Cy]),
        prev_M_re=jnp.stack([m[0] for m in new_M]),
        prev_M_im=jnp.stack([m[1] for m in new_M]),
        prev_Mr=jnp.stack(new_Mr))
    return y, new_state


def process_chunk(cfg: SpreaderConfig, w: SpreaderWeights,
                  state: SpreaderState, x_frames: jax.Array,
                  src_dirs_deg: jax.Array, src_spread_deg: jax.Array):
    """Scan-free multi-frame path: ``x_frames`` (nFrames, nSrc, F) →
    ((nFrames, Q, F), state), numerically equivalent to ``nFrames``
    consecutive :func:`process` calls (up to f32 summation order in the
    covariance EWMAs).

    Same recipe that took HADES from scan-bound to chip-limited
    (modules/hades.py HadesPipeline.chunk): the only cross-frame couplings
    are (a) the afSTFT / lattice-decorrelator streaming states — handled by
    running each filterbank ONCE over the concatenated chunk — and (b) the
    two one-pole covariance EWMAs plus the one-frame mixing-matrix
    crossfade, which are linear: each EWMA becomes a lower-triangular
    (nFrames × nFrames) matmul (ops.iir.onepole_ewma_mats) and the
    crossfade reads the frame-shifted M array.  Every remaining op carries
    a leading frame axis, so per-dispatch graph depth is that of ONE frame.
    Source directions/spreads are held constant across the chunk (the
    per-frame path streams them)."""
    from spatial_audio_framework_tpu.ops.iir import onepole_ewma_mats

    bank = cfg.afstft
    nF, nS, F = x_frames.shape
    Q = w.H_re.shape[1]
    hp = _prec.HOT
    x_cat = jnp.moveaxis(x_frames, 0, 1).reshape(nS, nF * F)
    (sre, sim), bank_st = ri.analysis_ri(bank, state.bank, x_cat)
    S_tot = sre.shape[-1]
    Hs = S_tot // nF                                   # slots per frame
    lam = cfg.cov_avg_coeff
    lat = _lat(cfg, Q)
    Lc, pc = onepole_ewma_mats(lam, nF)
    fade_in = jnp.arange(1, Hs + 1, dtype=jnp.float32) / Hs
    below = (w.freqs < MAX_SPREAD_FREQ)
    nB = bank.n_bands

    def frames(a):                                     # (B, Q, S) → (nF, B, Q, Hs)
        return jnp.moveaxis(a.reshape(nB, Q, nF, Hs), 2, 0)

    def ewma(new, init):
        """EWMA along the frame axis: new (nF, B, Q, Q), init (B, Q, Q)."""
        return (jnp.einsum("tk,kbqr->tbqr", Lc, new, precision=hp)
                + pc[:, None, None, None] * init)

    out = (jnp.zeros((nF, nB, Q, Hs), jnp.float32),
           jnp.zeros((nF, nB, Q, Hs), jnp.float32))
    new_lat, new_Cp, new_Cy, new_M, new_Mr = [], [], [], [], []

    for src in range(cfg.n_sources):
        spec_s = (sre[:, src], sim[:, src])            # (B, S)
        h_avg, Cy_st, h_c = _spread_statics(w, src_dirs_deg[src],
                                            src_spread_deg[src], below)
        proto = (h_avg[0][:, :, None] * spec_s[0][:, None, :]
                 - h_avg[1][:, :, None] * spec_s[1][:, None, :],
                 h_avg[0][:, :, None] * spec_s[1][:, None, :]
                 + h_avg[1][:, :, None] * spec_s[0][:, None, :])

        if cfg.mode == MODE_NAIVE:
            out = (out[0] + frames(proto[0]), out[1] + frames(proto[1]))
            new_lat.append(state.lattice[src])
            new_Cp.append((state.Cproto_re[src], state.Cproto_im[src]))
            new_Cy.append((state.Cy_re[src], state.Cy_im[src]))
            new_M.append((state.prev_M_re[src], state.prev_M_im[src]))
            new_Mr.append(state.prev_Mr[src])
            continue

        if cfg.mode == MODE_EVD:
            proto = (jnp.broadcast_to(spec_s[0][:, None, :],
                                      (nB, Q, S_tot)),
                     jnp.broadcast_to(spec_s[1][:, None, :],
                                      (nB, Q, S_tot)))
        # one streaming lattice call over the whole chunk == nF consecutive
        # per-frame calls (exact block-form IIR inside)
        dec_c, lat_st = decor.lattice_apply_ri(lat, w.lattice,
                                               state.lattice[src],
                                               proto[0], proto[1])
        pf = (frames(proto[0]), frames(proto[1]))      # (nF, B, Q, Hs)
        dec = (frames(dec_c[0]), frames(dec_c[1]))
        Cp_new = H.ceinsum("tbqh,tbrh->tbqr", pf, H.conj(pf))
        Cp = (ewma(Cp_new[0], state.Cproto_re[src]),
              ewma(Cp_new[1], state.Cproto_im[src]))

        # target covariance Cy_st: static across the chunk (dirs fixed)
        bel3 = below[:, None, None]
        if cfg.mode == MODE_OM:
            tr_y = jnp.einsum("bqq->b", Cy_st[0])
            sf = (jnp.moveaxis(spec_s[0].reshape(nB, nF, Hs), 1, 0),
                  jnp.moveaxis(spec_s[1].reshape(nB, nF, Hs), 1, 0))
            sc_re = (h_c[0][None, :, :, None] * sf[0][:, :, None, :]
                     - h_c[1][None, :, :, None] * sf[1][:, :, None, :])
            sc_im = (h_c[0][None, :, :, None] * sf[1][:, :, None, :]
                     + h_c[1][None, :, :, None] * sf[0][:, :, None, :])
            tr_e = (jnp.einsum("tbqh,tbqh->tb", sc_re, sc_re, precision=hp)
                    + jnp.einsum("tbqh,tbqh->tb", sc_im, sc_im,
                                 precision=hp))
            scale = jnp.where(below[None, :], tr_e / (tr_y[None] + 2.23e-9),
                              1.0)
            Cy_new = (Cy_st[0][None] * scale[..., None, None],
                      Cy_st[1][None] * scale[..., None, None])
        else:
            Cy_new = (jnp.broadcast_to(Cy_st[0], (nF, nB, Q, Q)),
                      jnp.broadcast_to(Cy_st[1], (nF, nB, Q, Q)))
        Cy = (ewma(Cy_new[0], state.Cy_re[src]),
              ewma(Cy_new[1], state.Cy_im[src]))

        if cfg.mode == MODE_EVD:
            e_y = jnp.einsum("tbqq->t", Cy[0])
            # per-(band, channel) 1e-6, as in process() (spreader.c:552)
            e_p = (jnp.einsum("tbqq->t", Cp[0])
                   + 1e-6 * (Cp[0].shape[1] * Cp[0].shape[2]))
            s = jnp.sqrt(e_p / (e_y + 2.23e-9))[:, None, None, None]
            if Q == 2:
                lam_e, V = H.cheev_2x2((Cy[0] * s, Cy[1] * s))
            else:
                lam_e, V = H.herm_eig_pairs((Cy[0] * s, Cy[1] * s))
                lam_e = lam_e[..., ::-1]
                V = (V[0][..., ::-1], V[1][..., ::-1])
            root = jnp.sqrt(jnp.maximum(lam_e, 0.0))[..., None, :]
            M = (V[0] * root, V[1] * root)
            Mr = jnp.zeros((nF, nB, Q, Q), jnp.float32)
            sig_in = dec
        else:  # OM
            eyeQ = jnp.eye(Q, dtype=jnp.float32)
            Cp_l = (Cp[0] + 1e-5 * eyeQ, Cp[1])
            Qid = (jnp.broadcast_to(eyeQ, Cp[0].shape), jnp.zeros_like(Cp[0]))
            M, Cr = cdf4sap.formulate_M_and_Cr_ri(Cp_l, Cy, Qid, False, 0.2)
            Cp_diag = jnp.einsum("tbqq->tbq", Cp[0])[..., None] * eyeQ
            zz = jnp.zeros_like(Cp_diag)
            Mr = cdf4sap.formulate_M_and_Cr_ri(
                (Cp_diag, zz), (Cr[0], zz), Qid, False, 0.2)[0][0]
            M = (jnp.where(bel3[None], M[0], eyeQ[None, None]),
                 jnp.where(bel3[None], M[1], 0.0))
            Mr = jnp.where(bel3[None], Mr, 0.0)
            sig_in = pf

        # crossfade against the PREVIOUS frame's target M (frame-shifted)
        Mp = (jnp.concatenate([state.prev_M_re[src][None], M[0][:-1]]),
              jnp.concatenate([state.prev_M_im[src][None], M[1][:-1]]))
        f = fade_in[None, None, :, None, None]
        M_t = (f * M[0][:, :, None] + (1 - f) * Mp[0][:, :, None],
               f * M[1][:, :, None] + (1 - f) * Mp[1][:, :, None])
        mixed = (jnp.einsum("tbhqr,tbrh->tbqh", M_t[0], sig_in[0])
                 - jnp.einsum("tbhqr,tbrh->tbqh", M_t[1], sig_in[1]),
                 jnp.einsum("tbhqr,tbrh->tbqh", M_t[0], sig_in[1])
                 + jnp.einsum("tbhqr,tbrh->tbqh", M_t[1], sig_in[0]))
        if cfg.mode == MODE_OM:
            Mrp = jnp.concatenate([state.prev_Mr[src][None], Mr[:-1]])
            f4 = fade_in[None, None, :, None, None]
            Mr_t = f4 * Mr[:, :, None] + (1 - f4) * Mrp[:, :, None]
            mixed = (mixed[0] + jnp.einsum("tbhqr,tbrh->tbqh", Mr_t, dec[0]),
                     mixed[1] + jnp.einsum("tbhqr,tbrh->tbqh", Mr_t, dec[1]))
        out = (out[0] + mixed[0], out[1] + mixed[1])
        new_lat.append(lat_st)
        new_Cp.append((Cp[0][-1], Cp[1][-1]))
        new_Cy.append((Cy[0][-1], Cy[1][-1]))
        new_M.append((M[0][-1], M[1][-1]))
        new_Mr.append(Mr[-1])

    out_cat = (jnp.moveaxis(out[0], 0, 2).reshape(nB, Q, S_tot),
               jnp.moveaxis(out[1], 0, 2).reshape(nB, Q, S_tot))
    y_cat, bank_st = ri.synthesis_ri(bank, bank_st, out_cat)
    ys = jnp.swapaxes(y_cat.reshape(Q, nF, F), 0, 1)
    new_state = SpreaderState(
        bank=bank_st, lattice=tuple(new_lat),
        Cproto_re=jnp.stack([c[0] for c in new_Cp]),
        Cproto_im=jnp.stack([c[1] for c in new_Cp]),
        Cy_re=jnp.stack([c[0] for c in new_Cy]),
        Cy_im=jnp.stack([c[1] for c in new_Cy]),
        prev_M_re=jnp.stack([m[0] for m in new_M]),
        prev_M_im=jnp.stack([m[1] for m in new_M]),
        prev_Mr=jnp.stack(new_Mr))
    return ys, new_state
