"""binauraliser — multi-source HRTF renderer (counterpart of
``examples/src/binauraliser``; call stack in SURVEY.md §3.2).

Design: HRIRs → ITDs → afSTFT-domain HRTFs (+diffuse-field EQ) and a
compressed 2°×5° VBAP interpolation table over the HRTF grid
(binauraliser_internal.c:186-249).  Process: per-source gains → afSTFT →
(optional traced rotation of source dirs) → per-source HRTF interpolation
(complex 'tri' or mag/ITD phase-synthesis 'tri_ps') → per-band mix, one
batched einsum → inverse afSTFT, scaled 1/√nSrc (binauraliser.c:191-275).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.modules import hrir as hrir_mod, vbap
from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops import precision as _prec

INTERP_TRI = "tri"
INTERP_TRI_PS = "tri_ps"


@dataclass(frozen=True)
class BinauraliserConfig:
    n_sources: int = 1
    fs: float = 48000.0
    interp_mode: str = INTERP_TRI
    enable_rotation: bool = False
    enable_hrir_diff_eq: bool = True
    hop: int = 128
    azi_res: int = 2                 # binauraliser_internal.c:210-211
    elev_res: int = 5

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class BinauraliserWeights(NamedTuple):
    hrtf_fb: jax.Array       # (nBands, 2, nDirs) complex64
    hrtf_mag: jax.Array      # (nBands, 2, nDirs)
    itds: jax.Array          # (nDirs,)
    table_w: jax.Array       # (nTable, 3) interpolation weights
    table_idx: jax.Array     # (nTable, 3) int32 HRTF-dir indices
    freqs: jax.Array         # (nBands,)


def _design_host(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
                 hrir_dirs_deg: Optional[np.ndarray] = None,
                 hrir_fs: Optional[int] = None,
                 sofa_filepath: Optional[str] = None,
                 rand_stream=None):
    if hrirs is None:
        # SOFA path with the reference's bad-file → default-set fallback
        # (binauraliser_internal.c: same block as ambi_bin.c:209-218)
        hrirs, hrir_dirs_deg, hrir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
    if hrir_fs != cfg.fs:
        hrirs, _ = hrir_mod.resample_hrirs(hrirs, hrir_fs, int(cfg.fs))
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    itds = hrir_mod.estimate_itds(hrirs, cfg.fs)
    hrtf_fb = hrir_mod.hrirs_to_hrtfs_afstft(hrirs, cfg.hop)
    weights = (geo.get_voronoi_weights(hrir_dirs_deg)
               if hrir_dirs_deg.shape[0] <= 1000 else None)
    if cfg.enable_hrir_diff_eq:
        hrtf_fb = hrir_mod.diffuse_field_equalise_hrtfs(
            hrtf_fb, itds, freqs, weights, apply_eq=True, apply_phase=False)
    gtable = vbap.generate_vbap_gain_table_3d(
        np.asarray(hrir_dirs_deg, np.float64), cfg.azi_res, cfg.elev_res,
        omit_large_triangles=True, enable_dummies=False,
        rand_stream=rand_stream)
    comp, idx = vbap.compress_vbap_gain_table_3d(gtable)
    return hrtf_fb, itds, comp, idx, freqs


def design(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
           hrir_dirs_deg: Optional[np.ndarray] = None,
           hrir_fs: Optional[int] = None,
           sofa_filepath: Optional[str] = None,
           rand_stream=None) -> BinauraliserWeights:
    hrtf_fb, itds, comp, idx, freqs = _design_host(cfg, hrirs, hrir_dirs_deg,
                                                   hrir_fs, sofa_filepath,
                                                   rand_stream=rand_stream)
    return BinauraliserWeights(
        hrtf_fb=jnp.asarray(hrtf_fb),
        hrtf_mag=jnp.asarray(np.abs(hrtf_fb).astype(np.float32)),
        itds=jnp.asarray(itds),
        table_w=jnp.asarray(comp), table_idx=jnp.asarray(idx),
        freqs=jnp.asarray(freqs))


class BinauraliserWeightsRI(NamedTuple):
    """Weights with the HRTF filterbank split into (re, im) float32 — no
    complex64 device arrays anywhere (see ops.afstft_ri's rationale)."""
    hrtf_re: jax.Array       # (nBands, 2, nDirs)
    hrtf_im: jax.Array
    hrtf_mag: jax.Array
    itds: jax.Array
    table_w: jax.Array
    table_idx: jax.Array
    freqs: jax.Array


def design_ri(cfg: BinauraliserConfig, hrirs: Optional[np.ndarray] = None,
              hrir_dirs_deg: Optional[np.ndarray] = None,
              hrir_fs: Optional[int] = None,
              sofa_filepath: Optional[str] = None,
              rand_stream=None) -> BinauraliserWeightsRI:
    """design() for the complex-free fast path (host-side re/im split)."""
    hrtf_fb, itds, comp, idx, freqs = _design_host(cfg, hrirs, hrir_dirs_deg,
                                                   hrir_fs, sofa_filepath,
                                                   rand_stream=rand_stream)
    return BinauraliserWeightsRI(
        hrtf_re=jnp.asarray(hrtf_fb.real.astype(np.float32)),
        hrtf_im=jnp.asarray(hrtf_fb.imag.astype(np.float32)),
        hrtf_mag=jnp.asarray(np.abs(hrtf_fb).astype(np.float32)),
        itds=jnp.asarray(itds),
        table_w=jnp.asarray(comp), table_idx=jnp.asarray(idx),
        freqs=jnp.asarray(freqs))


def init_state(cfg: BinauraliserConfig) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, 2)


def interp_hrtfs(cfg: BinauraliserConfig, w: BinauraliserWeights,
                 dirs_deg: jax.Array) -> jax.Array:
    """Traced per-source HRTF interpolation (binauraliser_interpHRTFs).
    dirs_deg: (nSrc, 2) → (nBands, 2, nSrc) complex."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    azi_idx = C.round_half_up(
        jnp.mod(dirs_deg[:, 0] + 180.0, 360.0) / cfg.azi_res)
    elev_idx = C.round_half_up((dirs_deg[:, 1] + 90.0) / cfg.elev_res)
    idx3d = (elev_idx * n_azi + azi_idx).astype(jnp.int32)  # (nSrc,)
    w3 = jnp.take(w.table_w, idx3d, axis=0)    # (nSrc, 3)
    i3 = jnp.take(w.table_idx, idx3d, axis=0)  # (nSrc, 3) dir indices
    if cfg.interp_mode == INTERP_TRI:
        h3 = w.hrtf_fb[:, :, i3]  # (nBands, 2, nSrc, 3)
        return jnp.einsum("besk,sk->bes", h3, w3.astype(w.hrtf_fb.dtype))
    # TRI_PS: interpolate magnitudes + ITD, synthesise IPD below 1.5 kHz
    m3 = w.hrtf_mag[:, :, i3]  # (nBands, 2, nSrc, 3)
    mag = jnp.einsum("besk,sk->bes", m3, w3)
    itd = jnp.einsum("sk,sk->s", w3, w.itds[i3])  # (nSrc,)
    f = w.freqs
    ipd = (jnp.mod(2.0 * jnp.pi * f[:, None] * itd[None, :] + jnp.pi,
                   2.0 * jnp.pi) - jnp.pi) / 2.0
    ipd = jnp.where((f < 1.5e3)[:, None], ipd, 0.0)  # (nBands, nSrc)
    phase = jnp.stack([ipd, -ipd], axis=1)  # (nBands, 2, nSrc)
    return mag * jnp.exp(1j * phase)


def interp_hrtfs_ri(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                    dirs_deg: jax.Array):
    """interp_hrtfs in split real/imaginary arithmetic:
    dirs_deg (nSrc, 2) → (Hre, Him) each (nBands, 2, nSrc)."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    azi_idx = C.round_half_up(
        jnp.mod(dirs_deg[:, 0] + 180.0, 360.0) / cfg.azi_res)
    elev_idx = C.round_half_up((dirs_deg[:, 1] + 90.0) / cfg.elev_res)
    idx3d = (elev_idx * n_azi + azi_idx).astype(jnp.int32)
    w3 = jnp.take(w.table_w, idx3d, axis=0)
    i3 = jnp.take(w.table_idx, idx3d, axis=0)
    if cfg.interp_mode == INTERP_TRI:
        Hre = jnp.einsum("besk,sk->bes", w.hrtf_re[:, :, i3], w3)
        Him = jnp.einsum("besk,sk->bes", w.hrtf_im[:, :, i3], w3)
        return Hre, Him
    m3 = w.hrtf_mag[:, :, i3]
    mag = jnp.einsum("besk,sk->bes", m3, w3)
    itd = jnp.einsum("sk,sk->s", w3, w.itds[i3])
    f = w.freqs
    ipd = (jnp.mod(2.0 * jnp.pi * f[:, None] * itd[None, :] + jnp.pi,
                   2.0 * jnp.pi) - jnp.pi) / 2.0
    ipd = jnp.where((f < 1.5e3)[:, None], ipd, 0.0)
    phase = jnp.stack([ipd, -ipd], axis=1)
    return mag * jnp.cos(phase), mag * jnp.sin(phase)


def process(cfg: BinauraliserConfig, w: BinauraliserWeights, state: AfSTFTState,
            x: jax.Array, src_dirs_deg: jax.Array,
            src_gains: Optional[jax.Array] = None,
            ypr: Optional[jax.Array] = None):
    """x: (nSrc, T) → ((2, T), state)."""
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2]).astype(x.dtype)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)
        # C applies the ROW convention: src_rot = src_row @ Rzyx, i.e.
        # R^T acting on column vectors (binauraliser.c:238-241)
        src_dirs_deg = geo.unit_cart2sph(u @ R, degrees=True)
    H = interp_hrtfs(cfg, w, src_dirs_deg)            # (nBands, 2, nSrc)
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)             # (nBands, nSrc, H)
    out = jnp.einsum("bes,bsh->beh", H.astype(spec.dtype), spec, precision=_prec.HOT)
    out = out / np.sqrt(cfg.n_sources)
    y, state = bank.synthesis(state, out)
    return y, state


# -- stream-batched fast path (complex-free) ---------------------------------

def init_state_batched(cfg: BinauraliserConfig, n_streams: int):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources, 2)


def process_ri_batched(cfg: BinauraliserConfig, w: BinauraliserWeightsRI,
                       state, x: jax.Array, src_dirs_deg: jax.Array,
                       src_gains: Optional[jax.Array] = None,
                       ypr: Optional[jax.Array] = None):
    """Stream-batched process: x (S, nSrc, T), src_dirs_deg (S, nSrc, 2),
    src_gains (S, nSrc) or None, ypr (S, 3) or None → ((S, 2, T), state).

    Runs on the split real/imaginary pipeline
    (ops.afstft_ri.render_tf_matrix_ri); the per-stream interpolated HRTFs
    become the per-stream mixing matrices.  Don't wrap in vmap — batching
    is native.
    """
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    if src_gains is not None:
        x = x * src_gains[..., None]
    if cfg.enable_rotation and ypr is not None:
        R = jax.vmap(lambda r: geo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
            ypr).astype(x.dtype)                        # (S, 3, 3)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)  # (S, nSrc, 3)
        u = jnp.einsum("zsj,zji->zsi", u, R)  # row convention, as above
        src_dirs_deg = geo.unit_cart2sph(u, degrees=True)
    Hre, Him = jax.vmap(lambda d: interp_hrtfs_ri(cfg, w, d))(src_dirs_deg)
    # (S, nBands, 2, nSrc) per-stream mixing matrices, complex-free
    y, state = ri.render_tf_matrix_ri(cfg.afstft, state, x, Hre, Him)
    return y / np.sqrt(cfg.n_sources), state
