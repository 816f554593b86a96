"""decorrelator — multi-channel decorrelator example (counterpart of
``examples/src/decorrelator``): afSTFT → optional transient ducking → lattice
all-pass decorrelation (+fixed per-band delays) → inverse afSTFT, with a
wet/dry ('decorrelation amount') mix.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.ops.afstft import AfSTFT, AfSTFTState
from spatial_audio_framework_tpu.utils import decor
from spatial_audio_framework_tpu.models import _common as C


@dataclass(frozen=True)
class DecorrelatorConfig:
    n_channels: int = 1
    fs: float = 48000.0
    decor_amount: float = 1.0       # decorrelator.h 'decorrelationAmount'
    enable_transient_ducker: bool = False  # decorrelator.c:38 (off by default)
    compensate_level: bool = False         # decorrelator.c:40 (off by default)
    hop: int = 128

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    @property
    def lattice(self) -> decor.LatticeDecorrelator:
        # orders/cutoffs as in decorrelator_internal.c initCodec
        return decor.LatticeDecorrelator(
            fs=self.fs, hop_size=self.hop, n_ch=self.n_channels,
            orders=(20, 15, 6, 3), freq_cutoffs=(600.0, 2.4e3, 4e3, 12e3),
            max_delay=8,            # decorrelator.c:150 'const int maxDelay'
            en_comp_coeff=0.75)     # decorrelator.c:152 last create arg

    def __post_init__(self):
        C.validate_config(self)


class DecorrelatorState(NamedTuple):
    bank: AfSTFTState
    lattice: decor.LatticeDecorState
    ducker: decor.TransientDuckerState


def design(cfg: DecorrelatorConfig, c_rand_offset: int = None) -> dict:
    """``c_rand_offset`` (optional): position of the C process's unseeded
    glibc rand() stream when its latticeDecorrelator_create ran — the delay
    draws then match the reference bit-exactly (0 for a process whose first
    rand() consumer is the decorrelator; see utils/decor.py
    get_decorrelation_delays_c)."""
    freqs = cfg.afstft.centre_freqs(cfg.fs)
    stream = None
    if c_rand_offset is not None:
        from spatial_audio_framework_tpu.utils.convhull3d import glibc_rand_at

        stream = glibc_rand_at(c_rand_offset)
    return cfg.lattice.design(freqs, c_rand_stream=stream)


def init_state(cfg: DecorrelatorConfig, design_data: dict) -> DecorrelatorState:
    n_bands = cfg.afstft.n_bands
    return DecorrelatorState(
        bank=cfg.afstft.init_state(cfg.n_channels, cfg.n_channels),
        lattice=cfg.lattice.init_state(design_data, n_bands),
        ducker=decor.transient_ducker_init(n_bands, cfg.n_channels))


def process(cfg: DecorrelatorConfig, design_data: dict,
            state: DecorrelatorState, x: jax.Array):
    """x: (nCH, T) → ((nCH, T), state)."""
    bank = cfg.afstft
    spec, bank_st = bank.analysis(state.bank, x)   # (nBands, nCH, H)
    frame = orig = spec
    ducker_st = state.ducker
    trans = None
    if cfg.enable_transient_ducker:
        # decorrelate only the residual (decorrelator.c:196-200)
        frame, trans, ducker_st = decor.transient_ducker_apply(ducker_st, frame)
    # the C's ducker path calls the lattice in place (decorrelator.c:199),
    # which flips the input-energy EWMA onto the delayed signal
    wet, lat_st = cfg.lattice.apply(design_data, state.lattice, frame,
                                    aliased_energy=cfg.enable_transient_ducker)
    if cfg.compensate_level:                       # decorrelator.c:205-208
        wet = wet * (0.75 * cfg.n_channels / np.sqrt(cfg.n_channels))
    if trans is not None:
        wet = wet + trans                          # decorrelator.c:211-215
    # wet/dry mix against the ORIGINAL input frame (decorrelator.c:218-221)
    out = cfg.decor_amount * wet + (1.0 - cfg.decor_amount) * orig
    y, bank_st = bank.synthesis(bank_st, out)
    return y, DecorrelatorState(bank=bank_st, lattice=lat_st, ducker=ducker_st)


# -- stream-batched fast path (complex-free) ---------------------------------

class DecorrelatorStateBatched(NamedTuple):
    bank: "object"                      # afstft_ri.AfSTFTStateBatched
    lattice: decor.LatticeDecorStateRI  # leaves carry a leading (S,) axis
    ducker: decor.TransientDuckerState  # leaves carry a leading (S,) axis


def init_state_batched(cfg: DecorrelatorConfig, design_data: dict,
                       n_streams: int) -> DecorrelatorStateBatched:
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    n_bands = cfg.afstft.n_bands
    lat1 = decor.lattice_init_state_ri(cfg.lattice, design_data, n_bands)
    duck1 = decor.transient_ducker_init(n_bands, cfg.n_channels)
    bc = lambda a: jnp.broadcast_to(a, (n_streams,) + a.shape) + 0.0
    return DecorrelatorStateBatched(
        bank=ri.init_state_batched(cfg.afstft, n_streams, cfg.n_channels,
                                   cfg.n_channels),
        lattice=jax.tree.map(bc, lat1),
        ducker=jax.tree.map(bc, duck1))


def process_ri_batched(cfg: DecorrelatorConfig, design_data: dict,
                       state: DecorrelatorStateBatched, x: jax.Array):
    """Stream-batched process on the complex-free pipeline:
    x (S, nCH, T) → ((S, nCH, T), state)."""
    from spatial_audio_framework_tpu.ops import afstft_ri as ri

    bank = cfg.afstft
    (sre, sim), bank_st = ri.analysis_ri_batched(bank, state.bank, x)
    # → per-stream (nBands, nCH, H) frames
    fre = jnp.moveaxis(sre, -1, 1)       # (S, nBands, nCH, H)
    fim = jnp.moveaxis(sim, -1, 1)
    orig_re, orig_im = fre, fim
    ducker_st = state.ducker
    tre = tim = None
    if cfg.enable_transient_ducker:
        # decorrelate only the residual (decorrelator.c:196-200)
        res, tr, ducker_st = jax.vmap(
            decor.transient_ducker_apply_ri)(state.ducker, fre, fim)
        (fre, fim), (tre, tim) = res, tr
    (wre, wim), lat_st = jax.vmap(
        lambda st, a, b: decor.lattice_apply_ri(
            cfg.lattice, design_data, st, a, b,
            aliased_energy=cfg.enable_transient_ducker))(
        state.lattice, fre, fim)
    if cfg.compensate_level:             # decorrelator.c:205-208
        comp = 0.75 * cfg.n_channels / np.sqrt(cfg.n_channels)
        wre, wim = wre * comp, wim * comp
    if tre is not None:                  # decorrelator.c:211-215
        wre, wim = wre + tre, wim + tim
    # wet/dry mix against the ORIGINAL input frame (decorrelator.c:218-221)
    out_re = cfg.decor_amount * wre + (1.0 - cfg.decor_amount) * orig_re
    out_im = cfg.decor_amount * wim + (1.0 - cfg.decor_amount) * orig_im
    Yre = jnp.moveaxis(out_re, 1, -1)    # (S, nCH, H, nBands)
    Yim = jnp.moveaxis(out_im, 1, -1)
    y, bank_st = ri.synthesis_ri_batched(bank, bank_st, (Yre, Yim))
    return y, DecorrelatorStateBatched(bank=bank_st, lattice=lat_st,
                                       ducker=ducker_st)
