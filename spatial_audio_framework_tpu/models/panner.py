"""panner — frequency-dependent VBAP/MDAP loudspeaker panner (counterpart of
``examples/src/panner``).

Design builds the 1°×1° VBAP gain table (omitLargeTriangles + dummies, as
panner_internal.c:77-82) and the per-band p-value exponents (Laitinen et al.
2014); process() looks panning gains up per (possibly rotated, traced) source
direction, renormalises per band by the p-norm, and mixes in the afSTFT
domain: one batched (bands × nLS × nSrc) complex matmul per block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.modules import vbap
from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu.utils import geometry as geo
from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops import precision as _prec


@dataclass(frozen=True)
class PannerConfig:
    n_sources: int = 1
    n_loudspeakers: int = 2
    fs: float = 48000.0
    dtt: float = 0.5                  # panner.c:58 (0: anechoic .. 1: room)
    spread_deg: float = 0.0
    azi_res: int = 1                  # panner_internal.c:77-78
    elev_res: int = 1
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class PannerWeights(NamedTuple):
    gtable: jax.Array      # (nElev*nAzi, nLS) float32
    p_values: jax.Array    # (nBands,)


def design(cfg: PannerConfig, ls_dirs_deg: np.ndarray) -> PannerWeights:
    ls = np.asarray(ls_dirs_deg, np.float64)
    # dimensionality: planar layouts (sum |elev| < 0.01) take the 2-D
    # pairwise tangent-law path (panner_internal.c:62-95); _table_lookup
    # dispatches on the table's (static) row count
    if np.abs(ls[:, 1]).sum() < 0.01:
        gtable = vbap.generate_vbap_gain_table_2d(ls, cfg.azi_res)
    else:
        gtable = vbap.generate_vbap_gain_table_3d(
            ls, cfg.azi_res, cfg.elev_res,
            omit_large_triangles=True, enable_dummies=True,
            spread=cfg.spread_deg)
    freq = cfg.afstft.centre_freqs(cfg.fs)
    p = vbap.get_p_values(cfg.dtt, freq)
    return PannerWeights(gtable=jnp.asarray(gtable), p_values=jnp.asarray(p))


def init_state(cfg: PannerConfig) -> AfSTFTState:
    return cfg.afstft.init_state(cfg.n_sources, cfg.n_loudspeakers)


def _table_lookup(cfg: PannerConfig, gtable: jax.Array, dirs_deg: jax.Array):
    """Nearest-grid lookup (panner.c:242-246 / :282-284 for the 2-D table):
    table rows are elev-major with azimuths -180..180; 2-D tables (static
    row count == nAzi) are azimuth-only."""
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    azi_idx = C.round_half_up(
        jnp.mod(dirs_deg[:, 0] + 180.0, 360.0) / cfg.azi_res)
    if gtable.shape[0] == n_azi:  # 2-D pairwise table
        idx = azi_idx.astype(jnp.int32)
    else:
        elev_idx = C.round_half_up((dirs_deg[:, 1] + 90.0) / cfg.elev_res)
        idx = (elev_idx * n_azi + azi_idx).astype(jnp.int32)
    return jnp.take(gtable, idx, axis=0)  # (nSrc, nLS)


def process(cfg: PannerConfig, weights: PannerWeights, state: AfSTFTState,
            x: jax.Array, src_dirs_deg: jax.Array,
            ypr: Optional[jax.Array] = None):
    """x: (nSrc, T); src_dirs_deg traced (nSrc, 2).  → ((nLS, T), state)."""
    if ypr is not None:
        R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2]).astype(x.dtype)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)
        u_rot = u @ R  # panner.c:220-223 NoTrans sgemm: dirs as rows × Rzyx
        src_dirs_deg = geo.unit_cart2sph(u_rot, degrees=True)
    g = _table_lookup(cfg, weights.gtable, src_dirs_deg)  # (nSrc, nLS)
    p = weights.p_values  # (nBands,)
    gp = jnp.maximum(g, 0.0)[None] ** p[:, None, None]  # (nBands, nSrc, nLS)
    norm = jnp.sum(gp, axis=-1) ** (1.0 / (p[:, None] + 2.23e-9))
    G = jnp.where((jnp.abs(p - 2.0) > 1e-6)[:, None, None],
                  g[None] / (norm[..., None] + 2.23e-9), g[None])
    bank = cfg.afstft
    spec, state = bank.analysis(state, x)              # (nBands, nSrc, H)
    # 1/sqrt(nSources) master scaling (panner.c:312-314)
    out = jnp.einsum("bsl,bsh->blh", G.astype(spec.dtype), spec,
                     precision=_prec.HOT) \
        / np.sqrt(cfg.n_sources)
    y, state = bank.synthesis(state, out)
    return y, state


# -- stream-batched fast path (complex-free) ---------------------------------

def init_state_batched(cfg: PannerConfig, n_streams: int, n_ls: int):
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return ri.init_state_batched(cfg.afstft, n_streams, cfg.n_sources, n_ls)


def process_ri_batched(cfg: PannerConfig, weights: PannerWeights, state,
                       x: jax.Array, src_dirs_deg: jax.Array,
                       ypr: Optional[jax.Array] = None):
    """Stream-batched process: x (S, nSrc, T), src_dirs_deg (S, nSrc, 2),
    ypr (S, 3) or None → ((S, nLS, T), state).  The frequency-dependent
    VBAP gains (real, per band) become per-stream mixing matrices on the
    complex-free pipeline (ops.afstft_ri.render_tf_matrix_ri)."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    if ypr is not None:
        R = jax.vmap(lambda r: geo.yaw_pitch_roll2_rzyx(r[0], r[1], r[2]))(
            ypr).astype(x.dtype)
        u = geo.unit_sph2cart(src_dirs_deg, degrees=True)
        u = jnp.einsum("zsj,zji->zsi", u, R)  # rows × Rzyx (panner.c:220)
        src_dirs_deg = geo.unit_cart2sph(u, degrees=True)
    g = jax.vmap(lambda d: _table_lookup(cfg, weights.gtable, d))(
        src_dirs_deg)                                   # (S, nSrc, nLS)
    p = weights.p_values
    gp = jnp.maximum(g, 0.0)[:, None] ** p[None, :, None, None]
    norm = jnp.sum(gp, axis=-1) ** (1.0 / (p[None, :, None] + 2.23e-9))
    G = jnp.where((jnp.abs(p - 2.0) > 1e-6)[None, :, None, None],
                  g[:, None] / (norm[..., None] + 2.23e-9), g[:, None])
    # G: (S, nBands, nSrc, nLS) → mixing (S, nBands, nLS, nSrc);
    # 1/sqrt(nSources) master scaling (panner.c:312-314)
    G = (jnp.swapaxes(G, -1, -2) / np.sqrt(cfg.n_sources)).astype(jnp.float32)
    return ri.render_tf_matrix_ri(cfg.afstft, state, x, G, None)
