"""binauraliser_nf — near-field binauraliser (counterpart of
``examples/src/binauraliser_nf``): the far-field binauraliser plus per-source
per-ear DVF high-shelf responses evaluated at the band centre frequencies and
applied as complex per-band gains (binauraliser_nf.c:287-330).

Everything is traced, so per-block source distances stream without
recompilation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import binauraliser as B
from spatial_audio_framework_tpu.ops.afstft import AfSTFTState
from spatial_audio_framework_tpu.utils import dvf as _dvf
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops import precision as _prec


@dataclass(frozen=True)
class BinauraliserNFConfig(B.BinauraliserConfig):
    head_radius: float = 0.09096        # binauraliser_nf.c:73
    # distances below this are clamped (the setter's floor, where the DVF
    # shelves stay stable — binauraliser_nf.c:77,378)
    nearfield_limit_m: float = 0.15

    @property
    def far_field_thresh_m(self) -> float:
        """Sources at/beyond this bypass the DVF entirely — derived from
        head_radius like the C (binauraliser_nf.c:75: head_radius·34)."""
        return self.head_radius * 34.0

    def __post_init__(self):
        C.validate_config(self)


def design(cfg: BinauraliserNFConfig, *args, **kw) -> B.BinauraliserWeights:
    return B.design(cfg, *args, **kw)


def init_state(cfg: BinauraliserNFConfig) -> AfSTFTState:
    return B.init_state(cfg)


def _dvf_band_gains(cfg: BinauraliserNFConfig, freqs: jax.Array,
                    src_dirs_deg: jax.Array, src_dists_m: jax.Array):
    """Per-source per-ear complex band gains from the DVF shelves.
    → (nBands, 2, nSrc) complex.

    Mirrors the reference EXACTLY, including two quirks
    (binauraliser_nf.c:304-341):
    * the per-band scale is the complex number (magnitude + j·phase_rad) of
      the shelf's transfer function — NOT mag·e^{jφ}; the C constructs
      cmplxf(dvfmags, dvfphases) despite its "apply magnitude & phase"
      comment;
    * sources at ≥ farfield_thresh_m (head_radius·34) bypass the DVF."""
    alpha_lr, _ = _dvf.doa_to_ipsi_interaural(src_dirs_deg[:, 0],
                                              src_dirs_deg[:, 1])  # (nSrc, 2)
    # the C clamps the DISTANCE to nearfield_limit_m in its setter
    # (binauraliser_nf.c:378), not rho to 1
    src_dists_m = jnp.maximum(src_dists_m, cfg.nearfield_limit_m)
    rho = jnp.maximum(src_dists_m / cfg.head_radius, 1.0)[:, None]
    b, a = _dvf.calc_dvf_coeffs(alpha_lr, rho, cfg.fs)  # (nSrc, 2, 2) each
    w = 2.0 * jnp.pi * freqs / cfg.fs  # (nBands,)
    z = jnp.exp(-1j * w)[:, None, None]  # (nBands, 1, 1)
    H = (b[..., 0] + b[..., 1] * z) / (1.0 + a[..., 1] * z)  # (nBands, nSrc, 2)
    scale = jnp.abs(H) + 1j * jnp.angle(H)
    far = (src_dists_m >= cfg.far_field_thresh_m)[None, :, None]
    scale = jnp.where(far, 1.0 + 0.0j, scale)
    return scale.transpose(0, 2, 1)  # (nBands, 2, nSrc)


def process(cfg: BinauraliserNFConfig, w: B.BinauraliserWeights,
            state: AfSTFTState, x: jax.Array, src_dirs_deg: jax.Array,
            src_dists_m: jax.Array, src_gains: Optional[jax.Array] = None,
            ypr: Optional[jax.Array] = None):
    """x: (nSrc, T); src_dists_m: traced (nSrc,) metres → ((2, T), state)."""
    if src_gains is not None:
        x = x * src_gains[:, None]
    if cfg.enable_rotation and ypr is not None:
        R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2]).astype(x.dtype)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)
        # C applies the ROW convention: src_rot = src_row @ Rzyx, i.e.
        # R^T acting on column vectors (binauraliser.c:238-241)
        src_dirs_deg = geo.unit_cart2sph(u @ R, degrees=True)
    H = B.interp_hrtfs(cfg, w, src_dirs_deg)            # (nBands, 2, nSrc)
    H = H * _dvf_band_gains(cfg, w.freqs, src_dirs_deg,
                            src_dists_m).astype(H.dtype)
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)
    out = jnp.einsum("bes,bsh->beh", H.astype(spec.dtype), spec, precision=_prec.HOT)
    out = out / np.sqrt(cfg.n_sources)
    y, state = bank.synthesis(state, out)
    return y, state


# -- stream-batched fast path (complex-free) ---------------------------------

def design_ri(cfg: BinauraliserNFConfig, *args, **kw):
    return B.design_ri(cfg, *args, **kw)


def init_state_batched(cfg: BinauraliserNFConfig, n_streams: int):
    return B.init_state_batched(cfg, n_streams)


def _dvf_band_gains_ri(cfg: BinauraliserNFConfig, freqs: jax.Array,
                       src_dirs_deg: jax.Array, src_dists_m: jax.Array):
    """_dvf_band_gains in real arithmetic: H(e^{-jw}) = (b0+b1 z)/(1+a1 z),
    z = cos w − j sin w → (Hre, Him) each (nBands, 2, nSrc)."""
    alpha_lr, _ = _dvf.doa_to_ipsi_interaural(src_dirs_deg[:, 0],
                                              src_dirs_deg[:, 1])
    src_dists_m = jnp.maximum(src_dists_m, cfg.nearfield_limit_m)  # c:378
    rho = jnp.maximum(src_dists_m / cfg.head_radius, 1.0)[:, None]
    b, a = _dvf.calc_dvf_coeffs(alpha_lr, rho, cfg.fs)  # (nSrc, 2, 2)
    wv = 2.0 * jnp.pi * freqs / cfg.fs
    c = jnp.cos(wv)[:, None, None]
    s = jnp.sin(wv)[:, None, None]
    nr = b[..., 0] + b[..., 1] * c
    ni = -b[..., 1] * s
    dr = 1.0 + a[..., 1] * c
    di = -a[..., 1] * s
    d2 = dr * dr + di * di
    Hre = (nr * dr + ni * di) / d2
    Him = (ni * dr - nr * di) / d2
    # reference quirk: scale = (|H|, arg H) as (re, im); far-field bypass
    # (see _dvf_band_gains)
    mag = jnp.sqrt(Hre * Hre + Him * Him)
    ph = jnp.arctan2(Him, Hre)
    far = (src_dists_m >= cfg.far_field_thresh_m)[None, :, None]
    mag = jnp.where(far, 1.0, mag)
    ph = jnp.where(far, 0.0, ph)
    return mag.transpose(0, 2, 1), ph.transpose(0, 2, 1)


def process_ri_batched(cfg: BinauraliserNFConfig, w, state, x: jax.Array,
                       src_dirs_deg: jax.Array, src_dists_m: jax.Array,
                       src_gains: Optional[jax.Array] = None,
                       ypr: Optional[jax.Array] = None):
    """Stream-batched near-field binauraliser on the complex-free pipeline:
    x (S, nSrc, T), src_dirs_deg (S, nSrc, 2), src_dists_m (S, nSrc)
    → ((S, 2, T), state).  w from :func:`design_ri`."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    if src_gains is not None:
        x = x * src_gains[..., None]
    if cfg.enable_rotation and ypr is not None:
        R = jax.vmap(lambda r: geo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
            ypr).astype(x.dtype)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)
        u = jnp.einsum("zsj,zji->zsi", u, R)  # row convention, as above
        src_dirs_deg = geo.unit_cart2sph(u, degrees=True)

    def per_stream(d, dist):
        Are, Aim = B.interp_hrtfs_ri(cfg, w, d)
        Bre, Bim = _dvf_band_gains_ri(cfg, w.freqs, d, dist)
        return Are * Bre - Aim * Bim, Are * Bim + Aim * Bre

    Hre, Him = jax.vmap(per_stream)(src_dirs_deg, src_dists_m)
    y, state = ri.render_tf_matrix_ri(cfg.afstft, state, x, Hre, Him)
    return y / np.sqrt(cfg.n_sources), state
