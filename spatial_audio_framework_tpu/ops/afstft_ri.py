"""afSTFT in split real/imaginary arithmetic (no complex64 anywhere).

Numerically identical to :mod:`ops.afstft` (same prototype, hybrid stage and
delays; afSTFT_internal.c:237-673) but every complex tensor is carried as an
(re, im) pair of float32 arrays: expressing the pipeline directly in real
arithmetic gives the compiler plain f32 matmuls and elementwise ops with no
complex-semantics boxing.

API mirrors AfSTFT: ``init_state_ri`` / ``analysis_ri`` / ``synthesis_ri``
with spectra as (re, im) tuples in BANDS_CH_TIME layout.
"""
from __future__ import annotations

import functools as _functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.ops.afstft import (_COEFF1, _COEFF2,
                                                    _TOTAL_HOPS, AfSTFT,
                                                    _windows, overlap_add)
from spatial_audio_framework_tpu.ops.fft import _rdft_mats
from spatial_audio_framework_tpu.ops import precision as _prec

# XLA-path analysis framing: largest 10×-overlapped frame stack worth
# materialising before _fold_hops_ri switches to slice-accumulation (the
# stack fuses into one reduce for a single instance but becomes a large
# device-memory temporary for many vmapped instances).  Tuned on an earlier
# accelerator; not measured on the H100.
_FOLD_STACK_BYTES = 16 * 2 ** 20
# analysis_ri: per-trace stack size below which the stacked fold + rDFT
# matmul is used instead of the conv formulation (tiny per-block calls,
# e.g. H=1).  Not measured on the H100.
_ANA_STACK_SMALL = 2 ** 20


class AfSTFTStateRI(NamedTuple):
    in_tail: jax.Array      # (n_ch_in, h_len - hop) float32
    hyb_tail_re: jax.Array  # (n_ch_in, 6, hop+1) float32
    hyb_tail_im: jax.Array
    ola_tail: jax.Array     # (n_ch_out, h_len - hop) float32


def init_state_ri(bank: AfSTFT, n_ch_in: int, n_ch_out: int) -> AfSTFTStateRI:
    hop, h_len = bank.hop, bank.h_len
    return AfSTFTStateRI(
        in_tail=jnp.zeros((n_ch_in, h_len - hop), jnp.float32),
        hyb_tail_re=jnp.zeros((n_ch_in, 6, hop + 1), jnp.float32),
        hyb_tail_im=jnp.zeros((n_ch_in, 6, hop + 1), jnp.float32),
        ola_tail=jnp.zeros((n_ch_out, h_len - hop), jnp.float32))


@_functools.lru_cache(maxsize=4)
def _ana_conv_kernel(hop: int, low_delay: bool) -> np.ndarray:
    """(10, hop, 2·(hop+1)) conv kernel fusing window ⊗ fold ⊗ rDFT.

    K[k, m, :] = w_ana[k·hop+m] · [C | S][(k%2)·hop+m, :]: sliding this
    over the hop axis computes sre|sim directly from the raw hop buffer —
    sre[c,h,f] = Σ_k Σ_m hops[c,h+k,m]·w[k·hop+m]·C[(k%2)·hop+m,f], the
    same sum the frame-stack → fold → matmul pipeline evaluates (only the
    reduction association differs, ~1 ulp·√(2·hop)).  ~4.8× the FLOPs of
    fold+rDFT, but the conv runs without materialising im2col frames at any
    batch size, including many vmapped instances (see _fold_hops_ri)."""
    w_ana, _ = _windows(hop, low_delay)
    C, S, _, _ = _rdft_mats(2 * hop)
    CS = np.concatenate([C, S], axis=1).astype(np.float32)
    K = np.empty((_TOTAL_HOPS, hop, CS.shape[1]), np.float32)
    for k in range(_TOTAL_HOPS):
        K[k] = (np.asarray(w_ana, np.float32)[k * hop:(k + 1) * hop, None]
                * CS[(k % 2) * hop:(k % 2 + 1) * hop, :])
    return K


def _fold_hops_ri(hops: jax.Array, n_frames: int, hop: int,
                  w: jax.Array) -> jax.Array:
    """Window ⊗ fold of the 10-hop overlapped afSTFT frames WITHOUT
    materialising the (..., n_frames, 10, hop) segment stack.

    Frame f's windowed 1280-tap span folds onto 2·hop points as five
    256-strided accumulations, and each accumulation term is a hop-shifted
    slice of ``hops`` times one 128-tap window slice — so the fold is ten
    slice-multiply-adds over (..., n_frames, hop) temporaries instead of a
    10× frame stack.  Summation runs p-ascending exactly like the previous
    ``reshape(.., 5, 2·hop).sum(axis=2)`` formulation (only the reduction
    association can differ, ~1 ulp).  This keeps many-instance vmapped
    analysers (powermap/sldoa/hades) from materialising a 10× stack of
    their input as a device-memory temporary.

    Below :data:`_FOLD_STACK_BYTES` the stacked formulation is kept: at
    one-instance scale the stack is a few MiB and fuses into a single
    reduce; the two only differ in reduction association (~1 ulp).

    hops: (..., n_frames + _TOTAL_HOPS - 1, hop); w: (_TOTAL_HOPS·hop,).
    Returns (..., n_frames, 2·hop).
    """
    stack_bytes = (4 * int(np.prod(hops.shape[:-2]))
                   * n_frames * _TOTAL_HOPS * hop)
    if stack_bytes <= _FOLD_STACK_BYTES:
        # small batch (e.g. one analyser instance): the stacked form fuses
        # into one reduce
        seg = jnp.stack([hops[..., k:k + n_frames, :]
                         for k in range(_TOTAL_HOPS)], axis=-2)
        frames = seg.reshape(hops.shape[:-2]
                             + (n_frames, _TOTAL_HOPS * hop)) * w
        return frames.reshape(hops.shape[:-2]
                              + (n_frames, _TOTAL_HOPS // 2,
                                 2 * hop)).sum(axis=-2)
    even = jnp.zeros(hops.shape[:-2] + (n_frames, hop), hops.dtype)
    odd = jnp.zeros_like(even)
    for p in range(_TOTAL_HOPS // 2):
        k0, k1 = 2 * p, 2 * p + 1
        even = even + (hops[..., k0:k0 + n_frames, :]
                       * w[k0 * hop:(k0 + 1) * hop])
        odd = odd + (hops[..., k1:k1 + n_frames, :]
                     * w[k1 * hop:(k1 + 1) * hop])
    return jnp.concatenate([even, odd], axis=-1)


def _hybrid_segments_ri(fre, fim, H: int):
    """Shared core of the real-pair hybrid filterbank (afstft._hybrid_forward):
    f*: (..., 6+H, hop+1) → ([re segments], [im segments]), each a 3-list
    [band0, split-pairs, bands 5:] to be concatenated on the last axis."""
    b = slice(1, 5)
    d3_re = fre[..., 3:3 + H, :]
    d3_im = fim[..., 3:3 + H, :]

    def inner(f):
        return (_COEFF1 * (f[..., 6:6 + H, b] - f[..., 0:H, b])
                + _COEFF2 * (f[..., 4:4 + H, b] - f[..., 2:2 + H, b]))

    # hb = 1j * inner  →  hb_re = -inner_im, hb_im = inner_re
    hb_re = -inner(fim)
    hb_im = inner(fre)
    s = jnp.asarray(np.array([-1.0, 1.0, -1.0, 1.0], np.float32))

    def halves(d3, hb):
        c = 0.5 * d3[..., b]
        lo = c + s * hb
        hi = c - s * hb
        pairs = jnp.stack([lo, hi], axis=-1).reshape(*lo.shape[:-1], 8)
        return [d3[..., :1], pairs, d3[..., 5:]]

    return halves(d3_re, hb_re), halves(d3_im, hb_im)


def _hybrid_forward_ri(fre, fim, H: int):
    """Real-pair version of afstft._hybrid_forward: f*: (..., 6+H, hop+1)
    (any number of leading batch dims)."""
    seg_re, seg_im = _hybrid_segments_ri(fre, fim, H)
    return (jnp.concatenate(seg_re, axis=-1),
            jnp.concatenate(seg_im, axis=-1))


def _hybrid_inverse_ri(Y):
    pairs = Y[..., 1:9].reshape(*Y.shape[:-1], 4, 2).sum(-1)
    return jnp.concatenate([Y[..., :1], pairs, Y[..., 9:]], axis=-1)


def _hybrid_forward_ri_packed(fre, fim, H: int):
    """_hybrid_forward_ri emitting one packed (..., H, 2·nHyb) tensor
    ([re | im] on the last axis) so downstream consumers read the spectrum
    once — the packing shares the assemble-concat, costing nothing extra."""
    seg_re, seg_im = _hybrid_segments_ri(fre, fim, H)
    return jnp.concatenate(seg_re + seg_im, axis=-1)


# -- natively stream-batched path ---------------------------------------------

class AfSTFTStateBatched(NamedTuple):
    """State for the (n_streams, ...) batched pipeline.

    in_tail carries 15 hops (9 for framing + 6 so the hybrid stage's history
    spectra are recomputed from the input instead of being carried)."""
    in_tail: jax.Array      # (S, n_ch_in, (10-1+6)*hop)
    ola_tail: jax.Array     # (S, n_ch_out, h_len - hop)


_TAIL_HOPS = _TOTAL_HOPS - 1 + 6  # 15


def init_state_batched(bank: AfSTFT, n_streams: int, n_ch_in: int,
                       n_ch_out: int) -> AfSTFTStateBatched:
    hop, h_len = bank.hop, bank.h_len
    S = n_streams
    return AfSTFTStateBatched(
        in_tail=jnp.zeros((S, n_ch_in, _TAIL_HOPS * hop), jnp.float32),
        ola_tail=jnp.zeros((S, n_ch_out, h_len - hop), jnp.float32))


def analysis_ri_batched(bank: AfSTFT, state: AfSTFTStateBatched, x: jax.Array,
                        packed: bool = False,
                        precision: Optional[str] = None):
    """x: (S, n_ch, H*hop) → ((re, im) each (S, n_ch, H, n_bands), state),
    or with ``packed`` one (S, n_ch, H, 2·n_bands) [re | im] tensor.

    Framing ⊗ window ⊗ fold runs as slice-accumulation over the hop axis
    (no 10×-overlapped frame stack) and the rDFT as one matmul; H+6 spectral
    hops are produced per block (6 recomputed from the carried tail) so the
    hybrid stage needs no carried spectral state.  ``precision``: matmul
    precision mode (ops/precision.py; None = the process default).
    """
    hop = bank.hop
    S, n_ch = x.shape[:2]
    H = x.shape[2] // hop
    buf = jnp.concatenate([state.in_tail, x], axis=-1)   # (S,C,(H+15)·hop)
    w_ana, _ = _windows(hop, bank.low_delay)
    C, Smat, _, _ = _rdft_mats(2 * hop)
    hops = buf.reshape(S * n_ch, H + _TAIL_HOPS, hop)
    folded = _fold_hops_ri(hops, H + 6, hop, jnp.asarray(w_ana))
    xprec = _prec.to_xla(_prec.resolve_mode(precision))
    sre = jnp.matmul(folded, jnp.asarray(C), precision=xprec)
    sim = jnp.matmul(folded, jnp.asarray(Smat), precision=xprec)
    sre = sre.reshape(S, n_ch, H + 6, hop + 1)
    sim = sim.reshape(S, n_ch, H + 6, hop + 1)
    state = state._replace(in_tail=buf[..., H * hop:])
    if packed:
        if not bank.hybrid:
            return jnp.concatenate([sre[:, :, 6:], sim[:, :, 6:]],
                                   axis=-1), state
        return _hybrid_forward_ri_packed(sre, sim, H), state
    if not bank.hybrid:
        return (sre[:, :, 6:], sim[:, :, 6:]), state
    ore, oim = _hybrid_forward_ri(sre, sim, H)               # (S,C,H,133)
    return (ore, oim), state


def synthesis_ri_batched(bank: AfSTFT, state: AfSTFTStateBatched, Y,
                         packed: bool = False,
                         precision: Optional[str] = None):
    """Y: (re, im) each (S, n_ch, H, n_bands) — or, with packed=True, one
    (S, n_ch, H, 2·n_bands) [re | im] tensor — → ((S, n_ch, H*hop), state).

    Hybrid-inverse ⊗ irDFT as matmuls, then window ⊗ overlap-add
    (:func:`ops.afstft.overlap_add`).  ``precision``: matmul precision mode (None =
    the process default)."""
    if packed:
        nb = Y.shape[-1] // 2
        Yre, Yim = Y[..., :nb], Y[..., nb:]
    else:
        Yre, Yim = Y
    hop = bank.hop
    _, w_syn = _windows(hop, bank.low_delay)
    _, _, A, B = _rdft_mats(2 * hop)
    if bank.hybrid:
        Yre = _hybrid_inverse_ri(Yre)
        Yim = _hybrid_inverse_ri(Yim)
    if bank.low_delay:
        sign = jnp.asarray(np.where(np.arange(hop + 1) % 2, -1.0, 1.0),
                           jnp.float32)
        Yre = Yre * sign
        Yim = Yim * sign
    xprec = _prec.to_xla(_prec.resolve_mode(precision))
    frame = (jnp.matmul(Yre, jnp.asarray(A), precision=xprec)
             + jnp.matmul(Yim, jnp.asarray(B), precision=xprec))
    y, tail = overlap_add(frame, state.ola_tail, w_syn, hop)
    return y, state._replace(ola_tail=tail)


def render_tf_matrix_ri(bank: AfSTFT, state: AfSTFTStateBatched, x: jax.Array,
                        Mre: jax.Array, Mim: Optional[jax.Array] = None,
                        precision: Optional[str] = None):
    """Generic TF-domain matrix renderer on the batched RI path: afSTFT
    analysis → per-band mixing matrix → afSTFT synthesis, the shape shared
    by ambi_bin / binauraliser / roombinauraliser / ambi_dec / panner /
    array2sh.

    x: (S, Cin, T); M: (B, Cout, Cin) shared across streams or
    (S, B, Cout, Cin) per-stream (e.g. per-stream interpolated HRTFs);
    Mim None ⇒ real mixing matrix.  → ((S, Cout, T), state).

    Plain XLA on every backend: analysis, one einsum over the packed
    spectrum for all bands, synthesis.  ``precision``: matmul precision
    mode (ops/precision.py; None = the process default).
    """
    cout = Mre.shape[-2]
    spec_p, state = analysis_ri_batched(bank, state, x, packed=True,
                                        precision=precision)
    S, cin, H, nb2 = spec_p.shape
    B = nb2 // 2
    spec5 = spec_p.reshape(S, cin, H, 2, B)
    per_stream = Mre.ndim == 4
    xprec = _prec.to_xla(_prec.resolve_mode(precision))
    if Mim is None:
        eq = "zbes,zshjb->zehjb" if per_stream else "bes,zshjb->zehjb"
        out = jnp.einsum(eq, Mre, spec5, precision=xprec)
    else:
        M4 = jnp.stack([jnp.stack([Mre, -Mim], axis=-1),
                        jnp.stack([Mim, Mre], axis=-1)], axis=-2)
        eq = "zbesij,zshjb->zehib" if per_stream else "besij,zshjb->zehib"
        out = jnp.einsum(eq, M4, spec5, precision=xprec)
    out_p = out.reshape(S, cout, H, nb2)
    return synthesis_ri_batched(bank, state, out_p, packed=True,
                                precision=precision)


def analysis_ri(bank: AfSTFT, state: AfSTFTStateRI, x: jax.Array,
                precision: Optional[str] = None
                ) -> Tuple[Tuple[jax.Array, jax.Array], AfSTFTStateRI]:
    """x: (n_ch, H*hop) → ((re, im) each (n_bands, n_ch, H), state).
    ``precision``: matmul precision mode (None = the process default)."""
    hop, h_len = bank.hop, bank.h_len
    n_ch = x.shape[0]
    H = x.shape[1] // hop
    buf = jnp.concatenate([state.in_tail, x], axis=-1)
    hops = buf.reshape(n_ch, H + _TOTAL_HOPS - 1, hop)
    xprec = _prec.to_xla(_prec.resolve_mode(precision))
    if 4 * n_ch * H * _TOTAL_HOPS * hop <= _ANA_STACK_SMALL:
        # per-block-scale calls (e.g. HADES: H=1 per 64-block scan): the
        # stacked fold + rDFT matmul is a single tiny fused op; the stack
        # is ≤256 KiB per trace
        w_ana, _ = _windows(hop, bank.low_delay)
        C, S = _rdft_mats(2 * hop)[:2]
        folded = _fold_hops_ri(hops, H, hop, jnp.asarray(w_ana))
        sre = jnp.matmul(folded, jnp.asarray(C), precision=xprec)
        sim = jnp.matmul(folded, jnp.asarray(S), precision=xprec)
    else:
        # framing ⊗ window ⊗ fold ⊗ rDFT as ONE 1-D convolution over the
        # hop axis (kernel (10, hop, 2·(hop+1)) = window-slice × rDFT-half
        # per overlap tap): no 10×-overlapped frame stack is materialised
        # at any batch size, including under vmap
        K = jnp.asarray(_ana_conv_kernel(hop, bank.low_delay))
        out = jax.lax.conv_general_dilated(
            hops, K, window_strides=(1,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"), precision=xprec)
        sre, sim = out[..., :hop + 1], out[..., hop + 1:]
    new_in_tail = buf[:, H * hop:]
    if not bank.hybrid:
        return ((sre.transpose(2, 0, 1), sim.transpose(2, 0, 1)),
                state._replace(in_tail=new_in_tail))
    fre = jnp.concatenate([state.hyb_tail_re, sre], axis=1)
    fim = jnp.concatenate([state.hyb_tail_im, sim], axis=1)
    ore, oim = _hybrid_forward_ri(fre, fim, H)
    return ((ore.transpose(2, 0, 1), oim.transpose(2, 0, 1)),
            state._replace(in_tail=new_in_tail,
                           hyb_tail_re=fre[:, H:H + 6],
                           hyb_tail_im=fim[:, H:H + 6]))


def synthesis_ri(bank: AfSTFT, state: AfSTFTStateRI,
                 Y: Tuple[jax.Array, jax.Array],
                 precision: Optional[str] = None):
    """Y: (re, im) each (n_bands, n_ch, H) → ((n_ch, H*hop), state).
    ``precision``: matmul precision mode (None = the process default)."""
    hop = bank.hop
    _, w_syn = _windows(hop, bank.low_delay)
    _, _, A, B = _rdft_mats(2 * hop)
    Yre = Y[0].transpose(1, 2, 0)
    Yim = Y[1].transpose(1, 2, 0)
    if bank.hybrid:
        Yre = _hybrid_inverse_ri(Yre)
        Yim = _hybrid_inverse_ri(Yim)
    if bank.low_delay:
        sign = jnp.asarray(np.where(np.arange(hop + 1) % 2, -1.0, 1.0),
                           jnp.float32)
        Yre = Yre * sign
        Yim = Yim * sign
    xprec = _prec.to_xla(_prec.resolve_mode(precision))
    frame = (jnp.matmul(Yre, jnp.asarray(A), precision=xprec)
             + jnp.matmul(Yim, jnp.asarray(B), precision=xprec))
    y, tail = overlap_add(frame, state.ola_tail, w_syn, hop)
    return y, state._replace(ola_tail=tail)
