"""ambi_roomsim — IMS shoebox → SH-receiver room simulator (counterpart of
``examples/src/ambi_roomsim``).

Design: build the shoebox scene (default wall absorptions from
ambi_roomsim.c:30), compute echograms at the given reflection order and
render broadband SH RIRs per (receiver, source) pair.  Process: streaming
partitioned convolution of the source signals with the RIR matrix — the
batched equivalent of the reference's per-image-source circular-buffer
applicator (``ims_shoebox_applyEchogramTD``); outputs are identical once the
RIR is rendered (the reference's TD path is itself a tap-accumulation of the
same echogram).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import numpy as np

from spatial_audio_framework_tpu.modules import reverb
from spatial_audio_framework_tpu.ops.matrix_conv import MatrixConv, MatrixConvState
from spatial_audio_framework_tpu.models import _common as C

DEFAULT_ABS_WALL = np.array([0.341055, 0.431295, 0.351295, 0.344335,
                             0.401775, 0.482095], np.float32)  # ambi_roomsim.c:30


@dataclass(frozen=True)
class AmbiRoomSimConfig:
    sh_order: int = 1
    n_sources: int = 1
    n_receivers: int = 1
    refl_order: int = 3
    fs: float = 48000.0
    room_dims: tuple = (10.0, 7.0, 4.0)
    hop: int = 128

    @property
    def nsh(self) -> int:
        return (self.sh_order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class AmbiRoomSimWeights(NamedTuple):
    Hf: jax.Array       # partitioned RIR spectra
    conv: MatrixConv


def design(cfg: AmbiRoomSimConfig, src_positions: np.ndarray,
           rec_positions: np.ndarray,
           abs_wall: np.ndarray = DEFAULT_ABS_WALL,
           _split_ri: bool = False) -> AmbiRoomSimWeights:
    """src_positions: (nSrc, 3); rec_positions: (nRec, 3) in room coords."""
    room = reverb.ShoeboxRoom(np.asarray(cfg.room_dims), abs_wall[None, :],
                              fs=cfg.fs)
    for p in np.atleast_2d(src_positions)[: cfg.n_sources]:
        room.add_source(p)
    for p in np.atleast_2d(rec_positions)[: cfg.n_receivers]:
        room.add_receiver_sh(cfg.sh_order, p)
    room.compute_echograms(max_order=cfg.refl_order)
    rirs = room.render_rirs()
    L = max(r.shape[-1] for r in rirs.values())
    n_out = cfg.n_receivers * cfg.nsh
    H = np.zeros((n_out, cfg.n_sources, L), np.float32)
    for (rid, sid), r in rirs.items():
        H[rid * cfg.nsh:(rid + 1) * cfg.nsh, sid, : r.shape[-1]] = r
    conv = MatrixConv(hop=cfg.hop, length_h=L, n_in=cfg.n_sources, n_out=n_out)
    if _split_ri:
        return AmbiRoomSimWeights(Hf=conv.design_ri(H), conv=conv)
    return AmbiRoomSimWeights(Hf=conv.design(H), conv=conv)


def design_ri(cfg: AmbiRoomSimConfig, src_positions, rec_positions,
              abs_wall: np.ndarray = DEFAULT_ABS_WALL) -> AmbiRoomSimWeights:
    """design() for the complex-free path: RIR partition spectra as an
    (re, im) float32 pair; use with init_state_ri/process_ri."""
    return design(cfg, src_positions, rec_positions, abs_wall, _split_ri=True)


def init_state_ri(cfg: AmbiRoomSimConfig,
                  w: AmbiRoomSimWeights) -> MatrixConvState:
    return w.conv.init_state_ri()


def process_ri(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
               state: MatrixConvState, x: jax.Array):
    """process() on the split real/imaginary partitioned convolver."""
    return w.conv.apply_block_ri(w.Hf, state, x)


def init_state(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights) -> MatrixConvState:
    return w.conv.init_state()


def process(cfg: AmbiRoomSimConfig, w: AmbiRoomSimWeights,
            state: MatrixConvState, x: jax.Array):
    """x: (nSrc, T) → ((nRec*nSH, T), state)."""
    return w.conv.apply_block(w.Hf, state, x)
