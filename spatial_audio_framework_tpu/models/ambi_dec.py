"""ambi_dec — frequency-dependent Ambisonic loudspeaker decoder (counterpart
of ``examples/src/ambi_dec``).

The reference's per-band machinery — dual decoders below/above the transition
frequency (ambi_dec.c:523), per-band decoding order, optional max-rE
weighting, and amplitude/energy-preserving normalisation (ambi_dec.c:255-345)
— is all static configuration, so design() folds the whole thing into ONE
(nBands, nLS, nSH) tensor; process() is afSTFT analysis → one batched einsum
→ synthesis.  Optional headphone preview (binauraliseLS) applies interpolated
HRTFs per loudspeaker as a second batched einsum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.modules import hoa, sh
from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu.utils import presets
from spatial_audio_framework_tpu.ops import precision as _prec

AMPLITUDE_PRESERVING = 0  # ambi_dec.h AMBI_DEC_DIFFUSE_FIELD_EQ_APPROACH
ENERGY_PRESERVING = 1


@dataclass(frozen=True)
class AmbiDecConfig:
    master_order: int = 1
    fs: float = 48000.0
    dec_method: tuple = ("allrad", "allrad")      # (low, high)
    re_weight: tuple = (True, True)                # ambi_dec.c:69-70
    diff_eq_mode: tuple = (ENERGY_PRESERVING, ENERGY_PRESERVING)
    transition_freq: float = 800.0                 # ambi_dec.c:73
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    binauralise_ls: bool = False
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class AmbiDecWeights(NamedTuple):
    M: jax.Array                 # (nBands, nLS, nSH) complex64
    H_bin: Optional[jax.Array]   # (nBands, 2, nLS) or None


class AmbiDecWeightsRI(NamedTuple):
    """Fast-path weights, complex-free: the real dual-band decoder, or (with
    binauralise_ls) the H_bin·M fold as an (re, im) float32 pair."""
    M_re: jax.Array              # (nBands, nOut, nSH)
    M_im: Optional[jax.Array]    # None for the pure loudspeaker decode


def _norm_factors(M_dec: np.ndarray, order: int) -> tuple[float, float]:
    """Amplitude/energy preservation factors from a t-design sweep
    (ambi_dec.c:305-335).  NOTE: the C fires plane waves through getSHreal
    (ORTHONORMAL real SH, no sqrt(4π)) — using getRSH here would shrink the
    factors by sqrt(4π)."""
    grid = presets.tdesign(30)
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y = sh.get_sh_real(order, dirs_rad)  # (nSH, nGrid) orthonormal
    g = M_dec @ Y  # (nLS, nGrid)
    a_avg = g.sum(0).mean()
    e_avg = (g ** 2).sum(0).mean()
    return 1.0 / (a_avg + 2.23e-6), float(np.sqrt(1.0 / (e_avg + 2.23e-6)))


def design(cfg: AmbiDecConfig, ls_dirs_deg: np.ndarray,
           order_per_band: Optional[np.ndarray] = None,
           hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           _split_ri: bool = False) -> AmbiDecWeights:
    ls_dirs_deg = np.asarray(ls_dirs_deg, np.float64)
    n_ls = ls_dirs_deg.shape[0]
    bank = cfg.afstft
    freqs = bank.centre_freqs(cfg.fs)
    n_bands = freqs.shape[0]
    mo = cfg.master_order
    if order_per_band is None:
        order_per_band = np.full(n_bands, mo, int)
    order_per_band = np.clip(np.asarray(order_per_band, int), 1, mo)

    # One glibc rand() stream shared across the whole design, consumed in
    # the C's initCodec order: the ALLRAD triangulations for d=0 then d=1
    # (ambi_dec.c:258-276) BEFORE the HRTF VBAP table (ambi_dec.c:402) — the
    # near-regular default-HRIR grid's triangulation is jitter-sensitive, so
    # the stream position at that third hull build matters for parity.
    from spatial_audio_framework_tpu.utils.convhull3d import glibc_rand

    rand_stream = glibc_rand()

    # per-decoder, per-order truncated + maxRE + norm variants
    M_full = {}
    for d in range(2):
        M_master = hoa.get_loudspeaker_decoder_mtx(ls_dirs_deg,
                                                   cfg.dec_method[d], mo,
                                                   rand_stream=rand_stream)
        for n in range(1, mo + 1):
            nsh_n = (n + 1) ** 2
            M_n = M_master[:, :nsh_n]
            norm_a, norm_e = _norm_factors(M_n, n)
            if cfg.re_weight[d]:
                M_n = M_n * hoa.get_max_re_weights(n)[None, :]
            gain = norm_a if cfg.diff_eq_mode[d] == AMPLITUDE_PRESERVING else norm_e
            M_full[(d, n)] = M_n * gain

    conv = C.input_conversion_mtx(mo, cfg.ch_ordering, cfg.norm)
    M = np.zeros((n_bands, n_ls, cfg.nsh), np.float64)
    for band in range(n_bands):
        d = 0 if freqs[band] < cfg.transition_freq else 1
        n = int(order_per_band[band])
        M[band, :, : (n + 1) ** 2] = M_full[(d, n)]
        M[band] = M[band] @ conv
    if _split_ri:
        # complex-free fast-path weights: M is real; with binauralise_ls the
        # headphone preview H_bin·M is folded on host into one RI pair
        if cfg.binauralise_ls:
            from spatial_audio_framework_tpu.models import binauraliser as _b

            # ambi_dec_interpHRTFs (ambi_dec_internal.c:59-115) is the
            # mag+ITD interpolation with IPD resynthesis below 1.5 kHz —
            # i.e. binauraliser's TRI_PS mode, always.
            bcfg = _b.BinauraliserConfig(n_sources=n_ls, fs=cfg.fs,
                                         hop=cfg.hop,
                                         interp_mode=_b.INTERP_TRI_PS)
            bwri = _b.design_ri(bcfg, hrirs, hrir_dirs_deg, hrir_fs,
                                rand_stream=rand_stream)
            Hre, Him = _b.interp_hrtfs_ri(
                bcfg, bwri, jnp.asarray(ls_dirs_deg, jnp.float32))
            scale = 1.0 / np.sqrt(n_ls)  # ambi_dec.c:563 sqrt(nLS) scaling
            Mre = scale * jnp.einsum("bel,bls->bes", Hre,
                                     jnp.asarray(M.astype(np.float32)))
            Mim = scale * jnp.einsum("bel,bls->bes", Him,
                                     jnp.asarray(M.astype(np.float32)))
            return AmbiDecWeightsRI(M_re=Mre, M_im=Mim)
        return AmbiDecWeightsRI(M_re=jnp.asarray(M.astype(np.float32)),
                                M_im=None)
    weights = AmbiDecWeights(M=jnp.asarray(M.astype(np.complex64)), H_bin=None)

    if cfg.binauralise_ls:
        from spatial_audio_framework_tpu.models import binauraliser as _bin

        # TRI_PS always + 1/sqrt(nLS) — see the RI branch above.
        bcfg = _bin.BinauraliserConfig(n_sources=n_ls, fs=cfg.fs, hop=cfg.hop,
                                       interp_mode=_bin.INTERP_TRI_PS)
        bw = _bin.design(bcfg, hrirs, hrir_dirs_deg, hrir_fs,
                         rand_stream=rand_stream)
        H = _bin.interp_hrtfs(bcfg, bw, jnp.asarray(ls_dirs_deg, jnp.float32))
        weights = weights._replace(H_bin=H / np.sqrt(n_ls))
    return weights


def design_ri(cfg: AmbiDecConfig, ls_dirs_deg, order_per_band=None,
              hrirs=None, hrir_dirs_deg=None, hrir_fs=None):
    """design() for the complex-free fast path (see AmbiDecWeightsRI)."""
    return design(cfg, ls_dirs_deg, order_per_band, hrirs, hrir_dirs_deg,
                  hrir_fs, _split_ri=True)


def init_state(cfg: AmbiDecConfig, n_ls: int) -> AfSTFTState:
    n_out = 2 if cfg.binauralise_ls else n_ls
    return cfg.afstft.init_state(cfg.nsh, n_out)


def process(cfg: AmbiDecConfig, w: AmbiDecWeights, state: AfSTFTState,
            x: jax.Array):
    """x: (nSH, T) → ((nLS or 2, T), state)."""
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)                # (nBands, nSH, H)
    out = jnp.einsum("bls,bsh->blh", w.M, spec, precision=_prec.HOT)          # (nBands, nLS, H)
    if cfg.binauralise_ls:
        out = jnp.einsum("bel,blh->beh", w.H_bin.astype(out.dtype), out, precision=_prec.HOT)
    y, state = bank.synthesis(state, out)
    return y, state


# -- stream-batched fast path (complex-free) ---------------------------------

def init_state_batched(cfg: AmbiDecConfig, n_streams: int, n_ls: int):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    n_out = 2 if cfg.binauralise_ls else n_ls
    return ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, n_out)


def process_ri_batched(cfg: AmbiDecConfig, w: AmbiDecWeightsRI, state,
                       x: jax.Array):
    """Stream-batched process on the split real/imaginary pipeline
    (ops.afstft_ri.render_tf_matrix_ri): x (S, nSH, T) → ((S, nLS or 2, T),
    state).  w from :func:`design_ri` (the dual-band decoder is a real
    per-band matrix; with binauralise_ls the folded H_bin·M RI pair)."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.render_tf_matrix_ri(cfg.afstft, state, x, w.M_re, w.M_im)
