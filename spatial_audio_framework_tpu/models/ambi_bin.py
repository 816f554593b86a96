"""ambi_bin — binaural Ambisonic decoder (counterpart of
``examples/src/ambi_bin``; see call-stack trace in SURVEY.md §3.1).

Design: ``design()`` performs the whole initCodec pipeline
(HRIR → ITDs → afSTFT filterbank HRTFs → Voronoi weights → diffuse-field EQ →
binaural decoder → truncation EQ) on host; the (ACN/N3D) input-convention
conversion is folded into the per-band decoding matrix, so ``process()`` is
exactly: afSTFT analysis → one batched complex matmul over the 133 bands →
afSTFT synthesis.  Head-tracking rotation is traced (recomputed per block via
the jax Ivanic recursion), so yaw/pitch/roll can be streamed without
recompilation — the analogue of the reference's recalc_M_rotFLAG baking
(ambi_bin.c:438-455).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.modules import hoa, hrir as hrir_mod, sh
from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.ops import precision as _prec

# HRIR_PREPROC_OPTIONS (ambi_bin.h)
PREPROC_OFF = "off"
PREPROC_EQ = "eq"
PREPROC_PHASE = "phase"
PREPROC_ALL = "all"


@dataclass(frozen=True)
class AmbiBinConfig:
    order: int = 1                      # ambi_bin.c:78 (bench uses 3)
    fs: float = 48000.0
    method: str = "magls"               # ambi_bin.c:77 DECODING_METHOD_MAGLS
    hrir_preproc: str = PREPROC_EQ      # ambi_bin.c:63
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D             # ambi_bin.c:65
    enable_max_re: bool = True
    enable_diff_cov_matching: bool = False
    enable_truncation_eq: bool = True   # only active for the LS method
    enable_rotation: bool = False
    hop: int = 128
    # Matmul precision of the process paths ('default'|'high'|'highest';
    # None = the process default from ops/precision.py /
    # SAF_MATMUL_PRECISION).
    matmul_precision: Optional[str] = None

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True, low_delay=False)

    def __post_init__(self):
        C.validate_config(self)


class AmbiBinWeights(NamedTuple):
    M_dec: jax.Array  # (nBands, 2, nSH) complex64, conventions folded in


def _design_host(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 hrir_fs: Optional[int] = None,
                 sofa_filepath: Optional[str] = None) -> np.ndarray:
    """Host-side initCodec pipeline → decode matrix as numpy complex."""
    if hrirs is None:
        # SOFA path with the reference's bad-file → default-set fallback
        # (ambi_bin.c:209-218 via hrir_mod.load_hrirs)
        hrirs, hrir_dirs_deg, hrir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
    if hrir_fs != cfg.fs:
        hrirs, _ = hrir_mod.resample_hrirs(hrirs, hrir_fs, int(cfg.fs))
    n_dirs = hrirs.shape[0]
    bank = cfg.afstft
    freq_vector = bank.centre_freqs(cfg.fs)

    itds = hrir_mod.estimate_itds(hrirs, cfg.fs)
    hrtf_fb = hrir_mod.hrirs_to_hrtfs_afstft(hrirs, cfg.hop)
    weights = (geo.get_voronoi_weights(hrir_dirs_deg) if n_dirs <= 1000 else None)
    hrtf_fb = hrir_mod.diffuse_field_equalise_hrtfs(
        hrtf_fb, itds, freq_vector, weights,
        apply_eq=cfg.hrir_preproc in (PREPROC_EQ, PREPROC_ALL),
        apply_phase=cfg.hrir_preproc in (PREPROC_PHASE, PREPROC_ALL))

    # The reference passes the Voronoi areas (sum 4π) straight through as
    # integration weights (ambi_bin.c:261-307): the LS-family solves are
    # invariant to the overall weight scale, and SPR rescales internally.
    dec = hoa.get_binaural_ambi_decoder_mtx(
        hrtf_fb, hrir_dirs_deg, cfg.method, cfg.order,
        freq_vector=freq_vector, itds=itds, weights=weights,
        enable_diff_cov_matching=cfg.enable_diff_cov_matching,
        enable_max_re_weighting=cfg.enable_max_re)

    # Truncation EQ (ambi_bin.c:310-364): LS method only, no phase preproc.
    if (cfg.enable_truncation_eq and cfg.method == "ls"
            and cfg.hrir_preproc not in (PREPROC_PHASE, PREPROC_ALL)):
        r, c, order_target = 0.085, 343.0, 42
        kr = 2.0 * np.pi / c * freq_vector.astype(np.float64) * r
        if cfg.enable_max_re:
            b = sh.beam_weights_max_ev(cfg.order).astype(np.float64)
            ns = np.arange(cfg.order + 1)
            w_n = b / np.sqrt((2 * ns + 1) / (4.0 * np.pi))
            w_n = w_n / w_n[0]
        else:
            w_n = np.ones(cfg.order + 1)
        gain = hoa.truncation_eq(w_n, cfg.order, order_target, kr,
                                 soft_threshold_db=9.0)
        dec = dec * gain[:, None, None]

    # Fold the input channel-order/normalisation conversion into the decoder.
    # EXCEPTION — FuMa ordering: its order-1 channel permutation does NOT
    # commute with the block-diagonal SH rotation, and the C converts the
    # signal FIRST and then applies M_dec·M_rot (ambi_bin.c:420-455), so for
    # FuMa the conversion is applied in process() AFTER the rotation instead.
    # Pure normalisation conversions are per-order scalars and commute.
    if cfg.ch_ordering == C.CH_FUMA:
        return dec
    conv = C.input_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    return np.einsum("bes,st->bet", dec, conv)


def _fuma_conv(cfg: AmbiBinConfig) -> Optional[np.ndarray]:
    """The input conversion NOT folded at design time (FuMa only) — applied
    right of the rotation in process/process_ri (see _design_host)."""
    if cfg.ch_ordering != C.CH_FUMA:
        return None
    return C.input_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)


def design(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           sofa_filepath: Optional[str] = None) -> AmbiBinWeights:
    """The initCodec pipeline (ambi_bin.c:167-380).  Pass a loaded SOFA set
    via (hrirs, hrir_dirs_deg, hrir_fs), a ``sofa_filepath`` (falls back to
    the default set on failure, like the reference), or neither."""
    dec = _design_host(cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath)
    return AmbiBinWeights(M_dec=jnp.asarray(dec.astype(np.complex64)))


def design_ri(cfg: AmbiBinConfig, hrirs: Optional[np.ndarray] = None,
              hrir_dirs_deg: Optional[np.ndarray] = None,
              hrir_fs: Optional[int] = None,
              sofa_filepath: Optional[str] = None):
    """design() for the split real/imaginary pipeline: returns (M_re, M_im)
    float32 device arrays WITHOUT ever creating a complex64 device array
    (some experimental runtimes mishandle complex transfers)."""
    dec = _design_host(cfg, hrirs, hrir_dirs_deg, hrir_fs, sofa_filepath)
    return (jnp.asarray(dec.real.astype(np.float32)),
            jnp.asarray(dec.imag.astype(np.float32)))


def init_state(cfg: AmbiBinConfig) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.nsh, C.NUM_EARS)


def process(cfg: AmbiBinConfig, weights: AmbiBinWeights, state: AfSTFTState,
            x: jax.Array, ypr: Optional[jax.Array] = None):
    """Process a block (ambi_bin.c:382-480).

    x: (nSH, T) SH signals, T a multiple of hop; ypr: traced (3,) radians
    (yaw, pitch, roll) if cfg.enable_rotation.  → ((2, T), state).
    """
    bank = cfg.afstft
    M = weights.M_dec
    if cfg.enable_rotation and cfg.order > 0:
        assert ypr is not None
        R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2])
        M_rot = sh.get_sh_rot_mtx_real(R.astype(jnp.float32), cfg.order)
        M = jnp.einsum("bes,st->bet", M, M_rot.astype(M.dtype),
                       precision=_prec.HOT)
    conv = _fuma_conv(cfg)
    if conv is not None:
        M = jnp.einsum("bes,st->bet", M,
                       jnp.asarray(conv.astype(np.complex64)),
                       precision=_prec.HOT)
    spec, state = bank.analysis(state, x)           # (nBands, nSH, H)
    out = jnp.einsum("bes,bsh->beh", M, spec, precision=_prec.HOT)       # batched over 133 bands
    y, state = bank.synthesis(state, out)           # (2, T)
    return y, state


# -- split real/imaginary pipeline (no complex64 in the graph) ---------------

def weights_ri(weights: AmbiBinWeights):
    """Split the decode matrix into an (re, im) float32 pair for process_ri.
    Runs on device (jit) so no host transfer of the complex weights occurs."""
    split = jax.jit(lambda M: (jnp.real(M).astype(jnp.float32),
                               jnp.imag(M).astype(jnp.float32)))
    return split(weights.M_dec)


def init_state_ri(cfg: AmbiBinConfig):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.init_state_ri(cfg.afstft, cfg.nsh, C.NUM_EARS)


def process_ri(cfg: AmbiBinConfig, w_ri, state, x: jax.Array,
               ypr: Optional[jax.Array] = None):
    """process() in split real/imaginary arithmetic (ops.afstft_ri): same
    math, no complex dtype anywhere in the compiled graph.  w_ri = (M_re,
    M_im) from :func:`weights_ri`; the complex per-band decode becomes four
    real einsums."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    bank = cfg.afstft
    hp = _prec.to_xla(_prec.resolve_mode(cfg.matmul_precision))
    Mre, Mim = w_ri
    if cfg.enable_rotation and cfg.order > 0:
        assert ypr is not None
        R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2])
        M_rot = sh.get_sh_rot_mtx_real(R.astype(jnp.float32), cfg.order)
        Mre = jnp.einsum("bes,st->bet", Mre, M_rot, precision=hp)
        Mim = jnp.einsum("bes,st->bet", Mim, M_rot, precision=hp)
    conv = _fuma_conv(cfg)
    if conv is not None:
        cv = jnp.asarray(conv.astype(np.float32))
        Mre = jnp.einsum("bes,st->bet", Mre, cv, precision=hp)
        Mim = jnp.einsum("bes,st->bet", Mim, cv, precision=hp)
    (sre, sim), state = ri.analysis_ri(bank, state, x,
                                       precision=cfg.matmul_precision)
    out_re = (jnp.einsum("bes,bsh->beh", Mre, sre, precision=hp)
              - jnp.einsum("bes,bsh->beh", Mim, sim, precision=hp))
    out_im = (jnp.einsum("bes,bsh->beh", Mre, sim, precision=hp)
              + jnp.einsum("bes,bsh->beh", Mim, sre, precision=hp))
    y, state = ri.synthesis_ri(bank, state, (out_re, out_im),
                               precision=cfg.matmul_precision)
    return y, state


def init_state_batched(cfg: AmbiBinConfig, n_streams: int):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, C.NUM_EARS)


def process_ri_batched(cfg: AmbiBinConfig, w_ri, state, x: jax.Array):
    """Stream-batched process_ri: x (S, nSH, T) → ((S, 2, T), state).

    The throughput configuration: all streams render in one call of
    ops.afstft_ri.render_tf_matrix_ri.  Don't wrap this in vmap — batching
    is native.
    """
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    mode = _prec.resolve_mode(cfg.matmul_precision)
    Mre, Mim = w_ri
    conv = _fuma_conv(cfg)
    if conv is not None:  # FuMa: conversion not folded at design time
        cv = jnp.asarray(conv.astype(np.float32))
        hp_c = _prec.to_xla(mode)
        Mre = jnp.einsum("bes,st->bet", Mre, cv, precision=hp_c)
        Mim = jnp.einsum("bes,st->bet", Mim, cv, precision=hp_c)
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, Mre, Mim,
                                  precision=mode)
