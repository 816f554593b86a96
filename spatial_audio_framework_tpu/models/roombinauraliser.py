"""roombinauraliser — multi-source BRIR renderer (counterpart of the fork's
``examples/src/roombinauraliser``; 1319-LoC BRIR example).

Renders each input source through its own set of binaural room impulse
responses (BRIRs, one grid of 2-ear IRs per source/emitter — e.g. loaded from
a MultiSpeakerBRIR SOFA file via :func:`modules.sofa.sofa_open`), with
head-rotation-driven interpolation over the BRIR measurement grid.

Design (roombinauraliser_internal.c:129-446 ``initHRTFsAndGainTables``):
per-source ITDs (on 1000-tap truncations) → optional resampling → a 2°×5°
compressed VBAP interpolation table over the grid (falling back to a 2-D
pairwise table when the grid has no elevation diversity,
roombinauraliser_internal.c:327-345) → afSTFT-domain BRTFs → optional
diffuse-field EQ, one of three modes (roombinauraliser.h:62-72):

* ``DIFF_EQ_FABIAN_CTF`` — multiply every band by the filterbank coefficients
  of the pre-generated FABIAN dummy-head common transfer function (256-tap IR
  embedded at roombinauraliser_internal.h:192, extracted to
  ``data/fabian_ctf.npz``; roombinauraliser_internal.c:372-396).
* ``DIFF_EQ_BRIR_CTF`` — classic diffuse-field equalisation computed from the
  loaded BRIR data itself, Voronoi-weighted when the grid is small enough
  (roombinauraliser_internal.c:398-436).
* ``DIFF_EQ_OWN_FILTER`` — a user-supplied CTF impulse response (loaded from
  its own SOFA file in the reference), applied like the FABIAN filter.

Process (roombinauraliser.c:196-289): per-source gains (solo/mute are folded
into the gain vector, roombinauraliser.c:441-469) → afSTFT → rotate the fixed
reference frame [1,0,0] by the head rotation and interpolate ALL sources'
BRTFs at that single direction (roombinauraliser.c:234-262 — BRIRs bake in
the true source positions, so only listener rotation moves the lookup) →
per-band complex mix (the reference's cblas_caxpy loop = one batched einsum
here) scaled 1/√nSources → inverse afSTFT.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.modules import hrir as hrir_mod, vbap
from spatial_audio_framework_tpu.ops.afstft import (AfSTFT, AfSTFTState,
                                                    fir_to_filterbank_coeffs)
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops import precision as _prec

INTERP_TRI = "tri"
INTERP_TRI_PS = "tri_ps"

# DIFF_EQ_MODES (roombinauraliser.h:68-72)
DIFF_EQ_FABIAN_CTF = "fabian_ctf"
DIFF_EQ_BRIR_CTF = "brir_ctf"
DIFF_EQ_OWN_FILTER = "own_filter"

# REINIT_MODES (roombinauraliser.h:75-80) — granularity hints for re-running
# design(); with a pure-functional design() a full re-run is always correct,
# the enum is kept for API parity.
REINIT_NONE = "none"
REINIT_RESAMPLE = "resample"
REINIT_FULL = "full"


@dataclass(frozen=True)
class RoomBinauraliserConfig:
    n_sources: int = 1
    fs: float = 48000.0
    interp_mode: str = INTERP_TRI
    enable_rotation: bool = True
    enable_hrir_diff_eq: bool = True
    diff_eq_mode: str = DIFF_EQ_BRIR_CTF
    hop: int = 128
    azi_res: int = 2                 # roombinauraliser_internal.c:320-321
    elev_res: int = 5
    vbap_3d: bool = True             # set by design() from the grid's extent
    # roombinauraliser_setEnablePartConv (roombinauraliser.h:192): in the
    # reference fork this flag is stored but never read by the processing
    # path (roombinauraliser.c:371-375 is a setter only) — kept for API
    # parity with identical (non-)behaviour.
    enable_part_conv: bool = False

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class RoomBinauraliserWeights(NamedTuple):
    hrtf_fb: jax.Array    # (nSrc, nBands, 2, nDirs) complex64  BRTF coeffs
    hrtf_mag: jax.Array   # (nSrc, nBands, 2, nDirs)
    itds: jax.Array       # (nSrc, nDirs)
    table_w: jax.Array    # (nTable, 3) interpolation weights
    table_idx: jax.Array  # (nTable, 3) int32 grid indices
    freqs: jax.Array      # (nBands,)


class RoomBinauraliserWeightsRI(NamedTuple):
    """Weights with the BRTF filterbank split into (re, im) float32 — no
    complex64 device arrays (see ops.afstft_ri's rationale)."""
    hrtf_re: jax.Array    # (nSrc, nBands, 2, nDirs)
    hrtf_im: jax.Array
    hrtf_mag: jax.Array
    itds: jax.Array
    table_w: jax.Array
    table_idx: jax.Array
    freqs: jax.Array


def fabian_ctf_ir() -> np.ndarray:
    """The FABIAN dummy-head CTF impulse response (256 taps @48 kHz,
    roombinauraliser_internal.h:192 ``fabian_ir``)."""
    import importlib.resources as _res

    with _res.files("spatial_audio_framework_tpu.data").joinpath(
            "fabian_ctf.npz").open("rb") as f:
        return np.load(f)["cir"].astype(np.float32)


def _ctf_filterbank(ir: np.ndarray, hop: int) -> np.ndarray:
    """CTF IR → per-band complex coeffs (nBands,)
    (roombinauraliser_internal.c:384)."""
    return fir_to_filterbank_coeffs(
        np.asarray(ir, np.float32)[None, None, :], hop)[:, 0, 0]


def design(cfg: RoomBinauraliserConfig,
           brirs: Optional[np.ndarray] = None,
           brir_dirs_deg: Optional[np.ndarray] = None,
           brir_fs: Optional[int] = None,
           own_ctf_ir: Optional[np.ndarray] = None,
           reinit: str = REINIT_FULL,
           _split_ri: bool = False,
           sofa_filepath: Optional[str] = None,
           ) -> Tuple[RoomBinauraliserConfig, RoomBinauraliserWeights]:
    """Codec init (roombinauraliser_initHRTFsAndGainTables).

    brirs: (nSrc, nDirs, 2, irLen) — one BRIR grid per source.  When None,
    ``sofa_filepath`` (if given) is loaded through utils/hdf5 and tiled
    across sources; an unloadable/ill-shaped file falls back — with a
    warning — to the default HRIR set tiled across sources (the reference's
    fallback, roombinauraliser_internal.c:154-158).  Returns (cfg',
    weights): cfg' has ``vbap_3d`` resolved from the grid's elevation
    extent.
    """
    del reinit  # pure-functional: full re-design is always performed
    if brirs is None:
        h, brir_dirs_deg, brir_fs, _ = hrir_mod.load_hrirs(sofa_filepath)
        brirs = np.broadcast_to(h, (cfg.n_sources,) + h.shape)
    brirs = np.asarray(brirs, np.float32)
    if brirs.shape[0] != cfg.n_sources:
        raise ValueError(f"expected {cfg.n_sources} BRIR sets, "
                         f"got {brirs.shape[0]}")
    brir_dirs_deg = np.asarray(brir_dirs_deg, np.float64)
    # wrap azimuths to -180..180 (roombinauraliser_internal.c:253)
    brir_dirs_deg = brir_dirs_deg.copy()
    brir_dirs_deg[:, 0] = (brir_dirs_deg[:, 0] + 180.0) % 360.0 - 180.0
    n_dirs = brir_dirs_deg.shape[0]

    # per-source ITDs on 1000-tap truncations (roombinauraliser_internal.c:263)
    itds = np.stack([hrir_mod.estimate_itds(brirs[s, :, :, :1000], brir_fs)
                     for s in range(cfg.n_sources)])

    if brir_fs != cfg.fs:
        brirs = np.stack([
            hrir_mod.resample_hrirs(brirs[s], brir_fs, int(cfg.fs))[0]
            for s in range(cfg.n_sources)])

    # 2-D vs 3-D interpolation table (roombinauraliser_internal.c:327-345)
    elev = brir_dirs_deg[:, 1]
    vbap_3d = abs(elev.max() - elev.min()) / 180.0 >= 1e-6
    if vbap_3d:
        gtable = vbap.generate_vbap_gain_table_3d(
            brir_dirs_deg, cfg.azi_res, cfg.elev_res,
            omit_large_triangles=True, enable_dummies=False)
    else:
        gtable = vbap.generate_vbap_gain_table_2d(brir_dirs_deg, cfg.azi_res)
    comp, idx = vbap.compress_vbap_gain_table_3d(gtable)
    cfg = replace(cfg, vbap_3d=vbap_3d)

    # BRIRs → afSTFT-domain coefficients (roombinauraliser_internal.c:365-368)
    hrtf_fb = np.stack([hrir_mod.hrirs_to_hrtfs_afstft(brirs[s], cfg.hop)
                        for s in range(cfg.n_sources)])
    freqs = cfg.afstft.centre_freqs(cfg.fs)

    if cfg.enable_hrir_diff_eq:
        if cfg.diff_eq_mode in (DIFF_EQ_FABIAN_CTF, DIFF_EQ_OWN_FILTER):
            ir = (fabian_ctf_ir() if cfg.diff_eq_mode == DIFF_EQ_FABIAN_CTF
                  else np.asarray(own_ctf_ir, np.float32))
            ctf = _ctf_filterbank(ir, cfg.hop)          # (nBands,)
            hrtf_fb = hrtf_fb * ctf[None, :, None, None]
        elif cfg.diff_eq_mode == DIFF_EQ_BRIR_CTF:
            weights = (geo.get_voronoi_weights(brir_dirs_deg)
                       if (vbap_3d and n_dirs <= 3600) else None)
            hrtf_fb = np.stack([
                hrir_mod.diffuse_field_equalise_hrtfs(
                    hrtf_fb[s], itds[s], freqs, weights,
                    apply_eq=True, apply_phase=False)
                for s in range(cfg.n_sources)])
        else:
            raise ValueError(f"unknown diff_eq_mode {cfg.diff_eq_mode!r}")

    if _split_ri:
        w = RoomBinauraliserWeightsRI(
            hrtf_re=jnp.asarray(hrtf_fb.real.astype(np.float32)),
            hrtf_im=jnp.asarray(hrtf_fb.imag.astype(np.float32)),
            hrtf_mag=jnp.asarray(np.abs(hrtf_fb).astype(np.float32)),
            itds=jnp.asarray(itds.astype(np.float32)),
            table_w=jnp.asarray(comp), table_idx=jnp.asarray(idx),
            freqs=jnp.asarray(freqs))
        return cfg, w
    return cfg, RoomBinauraliserWeights(
        hrtf_fb=jnp.asarray(hrtf_fb.astype(np.complex64)),
        hrtf_mag=jnp.asarray(np.abs(hrtf_fb).astype(np.float32)),
        itds=jnp.asarray(itds.astype(np.float32)),
        table_w=jnp.asarray(comp), table_idx=jnp.asarray(idx),
        freqs=jnp.asarray(freqs))


def design_ri(cfg: RoomBinauraliserConfig, brirs=None, brir_dirs_deg=None,
              brir_fs=None, own_ctf_ir=None):
    """design() for the complex-free fast path: BRTF coefficients split into
    (re, im) float32 on host (no complex64 device arrays)."""
    return design(cfg, brirs, brir_dirs_deg, brir_fs, own_ctf_ir,
                  _split_ri=True)


def init_state(cfg: RoomBinauraliserConfig) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, 2)


def solo_gains(n_sources: int, src_idx: Optional[int]) -> np.ndarray:
    """Gain vector for soloing one source / un-soloing (src_idx None)
    (roombinauraliser_setSourceSolo/setUnSolo, roombinauraliser.c:452-469)."""
    if src_idx is None:
        return np.ones(n_sources, np.float32)
    g = np.zeros(n_sources, np.float32)
    g[src_idx] = 1.0
    return g


def mute_gains(gains: np.ndarray, src_idx: int, mute: bool) -> np.ndarray:
    """Mute/unmute one source in a gain vector
    (roombinauraliser_setSourceMute, roombinauraliser.c:445-450)."""
    g = np.asarray(gains, np.float32).copy()
    g[src_idx] = 0.0 if mute else 1.0
    return g


def rotation_lookup_dir(ypr: jax.Array) -> jax.Array:
    """Head rotation → grid-lookup direction (azi, elev) degrees: rotate the
    fixed reference frame [1,0,0] (roombinauraliser.c:239-249)."""
    R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2])
    v = R[0]  # row-vector [1,0,0] @ R
    hyp = jnp.sqrt(v[0] ** 2 + v[1] ** 2)
    return jnp.degrees(jnp.stack([jnp.arctan2(v[1], v[0]),
                                  jnp.arctan2(v[2], hyp)]))


def interp_hrtfs(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeights,
                 rot_deg: jax.Array) -> jax.Array:
    """Interpolate every source's BRTF set at ONE direction
    (roombinauraliser_interpHRTFs, roombinauraliser_internal.c:46-127).
    rot_deg: (2,) [azi, elev] degrees → (nSrc, nBands, 2) complex."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    azi_idx = C.round_half_up(
        jnp.mod(rot_deg[0] + 180.0, 360.0) / cfg.azi_res)
    if cfg.vbap_3d:
        elev_idx = C.round_half_up((rot_deg[1] + 90.0) / cfg.elev_res)
    else:
        elev_idx = jnp.zeros(())  # roombinauraliser_internal.c:69-70
    idx3d = (elev_idx * n_azi + azi_idx).astype(jnp.int32)
    w3 = jnp.take(w.table_w, idx3d, axis=0)    # (3,)
    i3 = jnp.take(w.table_idx, idx3d, axis=0)  # (3,)
    if cfg.interp_mode == INTERP_TRI:
        h3 = w.hrtf_fb[:, :, :, i3]            # (nSrc, nBands, 2, 3)
        return jnp.einsum("sbek,k->sbe", h3, w3.astype(w.hrtf_fb.dtype))
    # TRI_PS: interpolate magnitudes + ITD, synthesise IPD below 1.5 kHz
    m3 = w.hrtf_mag[:, :, :, i3]
    mag = jnp.einsum("sbek,k->sbe", m3, w3)
    itd = w.itds[:, i3] @ w3                   # (nSrc,)
    f = w.freqs
    ipd = (jnp.mod(2.0 * jnp.pi * f[None, :] * itd[:, None] + jnp.pi,
                   2.0 * jnp.pi) - jnp.pi) / 2.0       # (nSrc, nBands)
    ipd = jnp.where((f < 1.5e3)[None, :], ipd, 0.0)
    phase = jnp.stack([ipd, -ipd], axis=-1)            # (nSrc, nBands, 2)
    return mag * jnp.exp(1j * phase)


def interp_hrtfs_ri(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeightsRI,
                    rot_deg: jax.Array):
    """interp_hrtfs in split real/imaginary arithmetic:
    rot_deg (2,) → (Hre, Him) each (nSrc, nBands, 2)."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    azi_idx = C.round_half_up(
        jnp.mod(rot_deg[0] + 180.0, 360.0) / cfg.azi_res)
    if cfg.vbap_3d:
        elev_idx = C.round_half_up((rot_deg[1] + 90.0) / cfg.elev_res)
    else:
        elev_idx = jnp.zeros(())
    idx3d = (elev_idx * n_azi + azi_idx).astype(jnp.int32)
    w3 = jnp.take(w.table_w, idx3d, axis=0)
    i3 = jnp.take(w.table_idx, idx3d, axis=0)
    if cfg.interp_mode == INTERP_TRI:
        Hre = jnp.einsum("sbek,k->sbe", w.hrtf_re[:, :, :, i3], w3)
        Him = jnp.einsum("sbek,k->sbe", w.hrtf_im[:, :, :, i3], w3)
        return Hre, Him
    m3 = w.hrtf_mag[:, :, :, i3]
    mag = jnp.einsum("sbek,k->sbe", m3, w3)
    itd = w.itds[:, i3] @ w3
    f = w.freqs
    ipd = (jnp.mod(2.0 * jnp.pi * f[None, :] * itd[:, None] + jnp.pi,
                   2.0 * jnp.pi) - jnp.pi) / 2.0
    ipd = jnp.where((f < 1.5e3)[None, :], ipd, 0.0)
    phase = jnp.stack([ipd, -ipd], axis=-1)
    return mag * jnp.cos(phase), mag * jnp.sin(phase)


def process(cfg: RoomBinauraliserConfig, w: RoomBinauraliserWeights,
            state: AfSTFTState, x: jax.Array,
            src_gains: Optional[jax.Array] = None,
            ypr: Optional[jax.Array] = None):
    """x: (nSrc, T) → ((2, T), state)  (roombinauraliser.c:196-289)."""
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        rot_deg = rotation_lookup_dir(ypr)
    else:
        rot_deg = jnp.zeros(2)
    H = interp_hrtfs(cfg, w, rot_deg)          # (nSrc, nBands, 2)
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)      # (nBands, nSrc, H)
    out = jnp.einsum("sbe,bsh->beh", H.astype(spec.dtype), spec,
                     precision=_prec.HOT)
    out = out / np.sqrt(cfg.n_sources)
    y, state = bank.synthesis(state, out)
    return y, state


# -- stream-batched fast path (complex-free) ---------------------------------

def init_state_batched(cfg: RoomBinauraliserConfig, n_streams: int):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources, 2)


def process_ri_batched(cfg: RoomBinauraliserConfig,
                       w: RoomBinauraliserWeightsRI,
                       state, x: jax.Array,
                       src_gains: Optional[jax.Array] = None,
                       ypr: Optional[jax.Array] = None):
    """Stream-batched process: x (S, nSrc, T), src_gains (S, nSrc) or None,
    ypr (S, 3) or None → ((S, 2, T), state) on the split real/imaginary
    pipeline (ops.afstft_ri.render_tf_matrix_ri)."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    S = x.shape[0]
    if src_gains is not None:
        x = x * src_gains[..., None]
    if cfg.enable_rotation and ypr is not None:
        rot_deg = jax.vmap(rotation_lookup_dir)(ypr)     # (S, 2)
    else:
        rot_deg = jnp.zeros((S, 2))
    Hre, Him = jax.vmap(lambda r: interp_hrtfs_ri(cfg, w, r))(rot_deg)
    # (S, nSrc, nBands, 2) → per-stream mixing (S, nBands, 2, nSrc)
    Hre = jnp.moveaxis(Hre, 1, -1)
    Him = jnp.moveaxis(Him, 1, -1)
    y, state = ri.render_tf_matrix_ri(cfg.afstft, state, x, Hre, Him)
    return y / np.sqrt(cfg.n_sources), state
