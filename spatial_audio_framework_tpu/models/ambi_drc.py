"""ambi_drc — frequency-dependent dynamic-range compressor in the SH domain
(counterpart of ``examples/src/ambi_drc``; Vilkamo et al. SMC 2013 design).

Per band and time slot, the gain is computed from the omni (W) channel and
applied to all SH channels (preserving the spatial properties,
ambi_drc.c:181-206).  The attack/release smoother is a per-band sequential
recurrence → lax.scan over time slots; everything else is elementwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState

SPECTRAL_FLOOR = 0.1585  # ambi_drc.h:76 (-16 dB)


@dataclass(frozen=True)
class AmbiDrcConfig:
    order: int = 1
    fs: float = 48000.0
    theshold_db: float = 0.0
    ratio: float = 8.0            # ambi_drc.c:66
    knee_db: float = 0.0
    in_gain_db: float = 0.0
    out_gain_db: float = 0.0
    attack_ms: float = 50.0       # ambi_drc.c:70
    release_ms: float = 100.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def __post_init__(self):
        C.validate_config(self)


class AmbiDrcState(NamedTuple):
    bank: AfSTFTState
    yl_z1: jax.Array  # (nBands,) smoother state


def init_state(cfg: AmbiDrcConfig) -> AmbiDrcState:
    return AmbiDrcState(bank=cfg.afstft.init_state(cfg.nsh, cfg.nsh),
                        yl_z1=jnp.zeros(cfg.afstft.n_bands, jnp.float32))


def _gain_computer(xg, T, R, W):
    """ambi_drc_internal.c:46 ``ambi_drc_gainComputer``."""
    soft = xg + (1.0 / R - 1.0) * (xg - T + W / 2.0) ** 2 / (2.0 * W + 1e-12)
    above = T + (xg - T) / R
    yg = jnp.where(2.0 * (xg - T) < -W, xg,
                   jnp.where(2.0 * jnp.abs(xg - T) <= W, soft, above))
    return yg


def process(cfg: AmbiDrcConfig, state: AmbiDrcState, x: jax.Array):
    """x: (nSH, T) → ((nSH, T), state).  NOTE: the reference applies its gain
    in the (chOrdering, norm) the user selected without converting — the
    omni/W channel is the same in all conventions up to a scale, which the
    threshold absorbs."""
    bank = cfg.afstft
    spec, bank_st = bank.analysis(state.bank, x)  # (nBands, nSH, H)
    n_slots = spec.shape[-1]
    boost = 10.0 ** (cfg.in_gain_db / 20.0)
    makeup = 10.0 ** (cfg.out_gain_db / 20.0)
    spec = spec * boost
    # per-(band, slot) smoothed gain from the omni channel (ambi_drc.c:157-8)
    alpha_a = jnp.exp(-1.0 / (cfg.attack_ms * 0.001 * cfg.fs
                              / (cfg.hop)))
    alpha_r = jnp.exp(-1.0 / (cfg.release_ms * 0.001 * cfg.fs
                              / (cfg.hop)))
    xg = 10.0 * jnp.log10(jnp.abs(spec[:, 0, :]) ** 2 + 2e-13)  # (nBands, H)
    yg = _gain_computer(xg, cfg.theshold_db, cfg.ratio, cfg.knee_db)
    xl = xg - yg

    def smooth(yl_z1, xl_t):
        yl = jnp.where(xl_t > yl_z1,
                       alpha_a * yl_z1 + (1 - alpha_a) * xl_t,
                       alpha_r * yl_z1 + (1 - alpha_r) * xl_t)
        return yl, yl

    yl_last, yl = jax.lax.scan(smooth, state.yl_z1, jnp.moveaxis(xl, -1, 0))
    yl = jnp.moveaxis(yl, 0, -1)  # (nBands, H)
    cdb = jnp.maximum(SPECTRAL_FLOOR, jnp.sqrt(10.0 ** (-yl / 20.0)))
    out = spec * (cdb * makeup)[:, None, :].astype(spec.dtype)
    y, bank_st = bank.synthesis(bank_st, out)
    return y, AmbiDrcState(bank=bank_st, yl_z1=yl_last)


# -- stream-batched fast path (complex-free) ---------------------------------

class AmbiDrcStateBatched(NamedTuple):
    bank: "object"      # ops.afstft_ri.AfSTFTStateBatched
    yl_z1: jax.Array    # (S, nBands) smoother state


def init_state_batched(cfg: AmbiDrcConfig, n_streams: int) -> AmbiDrcStateBatched:
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    return AmbiDrcStateBatched(
        bank=ri.init_state_batched(cfg.afstft, n_streams, cfg.nsh, cfg.nsh),
        yl_z1=jnp.zeros((n_streams, cfg.afstft.n_bands), jnp.float32))


def process_ri_batched(cfg: AmbiDrcConfig, state: AmbiDrcStateBatched,
                       x: jax.Array):
    """Stream-batched process on the complex-free pipeline:
    x (S, nSH, T) → ((S, nSH, T), state).  The per-(band, slot) gain comes
    from the omni magnitude √(re²+im²) and multiplies both halves of the
    packed spectrum."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    bank = cfg.afstft
    spec_p, bank_st = ri.analysis_ri_batched(bank, state.bank, x,
                                             packed=True)
    S, _, H, nb2 = spec_p.shape
    B = nb2 // 2
    boost = 10.0 ** (cfg.in_gain_db / 20.0)
    makeup = 10.0 ** (cfg.out_gain_db / 20.0)
    spec_p = spec_p * boost
    w_pow = (spec_p[:, 0, :, :B] ** 2
             + spec_p[:, 0, :, B:] ** 2)              # (S, H, B)
    alpha_a = jnp.exp(-1.0 / (cfg.attack_ms * 0.001 * cfg.fs / cfg.hop))
    alpha_r = jnp.exp(-1.0 / (cfg.release_ms * 0.001 * cfg.fs / cfg.hop))
    xg = 10.0 * jnp.log10(w_pow + 2e-13)              # (S, H, B)
    yg = _gain_computer(xg, cfg.theshold_db, cfg.ratio, cfg.knee_db)
    xl = jnp.moveaxis(xg - yg, 1, 0)                  # (H, S, B)

    def smooth(yl_z1, xl_t):
        yl = jnp.where(xl_t > yl_z1,
                       alpha_a * yl_z1 + (1 - alpha_a) * xl_t,
                       alpha_r * yl_z1 + (1 - alpha_r) * xl_t)
        return yl, yl

    yl_last, yl = jax.lax.scan(smooth, state.yl_z1, xl)
    yl = jnp.moveaxis(yl, 0, 1)                       # (S, H, B)
    cdb = jnp.maximum(SPECTRAL_FLOOR, jnp.sqrt(10.0 ** (-yl / 20.0)))
    g = (cdb * makeup)[:, None]                       # (S, 1, H, B)
    out_p = spec_p * jnp.concatenate([g, g], axis=-1)
    y, bank_st = ri.synthesis_ri_batched(bank, bank_st, out_p, packed=True)
    return y, AmbiDrcStateBatched(bank=bank_st, yl_z1=yl_last)
