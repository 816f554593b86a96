"""Alias-free STFT filterbank (afSTFT).

Re-design of the reference afSTFT (``framework/resources/afSTFT/``,
Juha Vilkamo's alias-free STFT as described in Vilkamo & Backstrom 2018):
a complex uniform filterbank with ``hop+1`` bands built from a 10·hop-long
prototype filter (Lin & Vaidyanathan design), plus an optional "hybrid" stage
that splits bands 1–4 with 7-tap half-band filters along hop-time, giving
``hop+5`` bands (133 for hop=128).

Reference behaviour reproduced exactly (verified by round-trip tests against
the reference's own tolerances, ``test/src/test__resources.c:27-89``):

* analysis  = ring-buffer fold of the windowed 10·hop segment into a 2·hop
  frame + rFFT                       (``afSTFT_internal.c:237-330``)
* synthesis = 1/N-scaled irFFT + weighted overlap-add over 10 hops
  (``afSTFT_internal.c:333-455``)
* hybrid    = half-band FIR along time at bands 1–4, +3 hops latency
  (``afSTFT_internal.c:523-641``; coefficients ``afSTFT_internal.h:73-76``)
* latency   = 12·hop (hybrid) / 9·hop; low-delay: 7·hop / 4·hop
  (``afSTFTlib.c:167-169``)

Architecture: instead of the reference's one-hop-per-call mutable
handle, the filterbank is a pure function over a *block* of H hops with an
explicit state pytree.  All hops in a block are processed as one batched
window-multiply + fold + batched rFFT, so arbitrarily many hops,
channels and streams can be fused into large dense ops (vmap over streams).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.ops.fft import force_dft_impl, irfft_op, rfft_op

# Half-band ("hybrid") filter coefficients, afSTFT_internal.h:73-76.
_COEFF1 = 0.031273141818515176604
_COEFF2 = 0.28127313041521179171

# Prototype-filter energy normalisers, afSTFT_internal.c:124-146.
_EQ_NORMAL = 2.0 / np.sqrt(5.487604141)
_EQ_LD = 2.0 / np.sqrt(4.544559956)

_TOTAL_HOPS = 10  # prototype length = 10 * hop (afSTFT_internal.c:80)


@functools.lru_cache(maxsize=None)
def _load_proto() -> dict[str, np.ndarray]:
    import importlib.resources as res

    path = res.files("spatial_audio_framework_tpu").joinpath("data/afstft_proto.npz")
    with path.open("rb") as f:
        z = np.load(f)
        return {"normal": z["proto1024"].copy(), "ld": z["proto1024_ld"].copy()}


def _windows(hop: int, low_delay: bool) -> tuple[np.ndarray, np.ndarray]:
    """Analysis/synthesis windows of length 10*hop (afSTFT_internal.c:122-148).

    The reference stores the prototype time-reversed into ``protoFilter`` and
    (for normal mode) the same into ``protoFilterI``; in low-delay mode the
    synthesis filter is kept in forward order.
    """
    ds = 1024 // hop
    if 1024 % hop or hop < 32:
        raise ValueError(f"unsupported hop size {hop}")
    proto = _load_proto()["ld" if low_delay else "normal"][::ds]
    eq = _EQ_LD if low_delay else _EQ_NORMAL
    w_ana = (proto[::-1] * eq).astype(np.float32)
    w_syn = (proto * eq).astype(np.float32) if low_delay else w_ana
    return w_ana, w_syn


@dataclass(frozen=True)
class AfSTFT:
    """Static configuration (the analogue of afSTFT_create's arguments)."""

    hop: int = 128
    hybrid: bool = True
    low_delay: bool = False

    @property
    def n_bands(self) -> int:
        return self.hop + (5 if self.hybrid else 1)

    @property
    def proc_delay(self) -> int:
        """Latency in samples (afSTFTlib.c:167-169)."""
        if self.low_delay:
            return (7 if self.hybrid else 4) * self.hop
        return (12 if self.hybrid else 9) * self.hop

    @property
    def h_len(self) -> int:
        return _TOTAL_HOPS * self.hop

    def centre_freqs(self, fs: float) -> np.ndarray:
        """Band centre frequencies (afSTFTlib.c:545-590)."""
        uni = np.arange(self.hop + 1, dtype=np.float64) * fs / (2.0 * self.hop)
        if not self.hybrid:
            return uni.astype(np.float32)
        # First 5 uniform bins map to 9 hybrid bands (afSTFTlib.c:96-107).
        stft2hyb = np.array(
            [1.0, 0.7501, 1.2499, 0.8751, 1.1249, 0.9167, 1.0833, 0.9375, 1.0625]
        )
        src = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4])
        return np.concatenate([stft2hyb * uni[src], uni[5:]]).astype(np.float32)

    # -- state -------------------------------------------------------------
    def init_state(self, n_ch_in: int, n_ch_out: int, dtype=jnp.float32) -> "AfSTFTState":
        hop, h_len = self.hop, self.h_len
        cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
        return AfSTFTState(
            in_tail=jnp.zeros((n_ch_in, h_len - hop), dtype),
            hyb_tail=jnp.zeros((n_ch_in, 6, hop + 1), cdtype),
            ola_tail=jnp.zeros((n_ch_out, h_len - hop), dtype),
        )

    # -- jit-safe functional API --------------------------------------------
    def analysis(self, state: "AfSTFTState", x: jax.Array):
        """Forward transform of a block.

        x: (n_ch, H*hop) time-domain block → (n_bands, n_ch, H) complex,
        matching the reference's BANDS_CH_TIME format (afSTFTlib.h:84-90).
        """
        hop, h_len = self.hop, self.h_len
        n_ch = x.shape[0]
        H = x.shape[1] // hop
        w_ana, _ = _windows(hop, self.low_delay)
        buf = jnp.concatenate([state.in_tail, x], axis=-1)
        # (n_ch, H, h_len) sliding windows (oldest sample first), built from
        # hop-granular slices.
        hops = buf.reshape(n_ch, H + _TOTAL_HOPS - 1, hop)
        seg = jnp.stack([hops[:, k : k + H] for k in range(_TOTAL_HOPS)], axis=2)
        frames = seg.reshape(n_ch, H, h_len) * jnp.asarray(w_ana)
        # Fold (time-alias) the windowed segment into a 2*hop frame: hop k of
        # the segment lands at offset (k % 2)*hop (afSTFT_internal.c:266-299).
        folded = frames.reshape(n_ch, H, _TOTAL_HOPS // 2, 2 * hop).sum(axis=2)
        spec = rfft_op(folded, 2 * hop)  # (n_ch, H, hop+1), unnormalised
        new_in_tail = buf[:, H * hop:]
        if not self.hybrid:
            return spec.transpose(2, 0, 1), state._replace(in_tail=new_in_tail)
        full = jnp.concatenate([state.hyb_tail, spec], axis=1)  # (n_ch, 6+H, hop+1)
        out = _hybrid_forward(full, H)
        return out.transpose(2, 0, 1), state._replace(
            in_tail=new_in_tail, hyb_tail=full[:, H : H + 6]
        )

    def synthesis(self, state: "AfSTFTState", Y: jax.Array):
        """Inverse transform of a block.

        Y: (n_bands, n_ch, H) complex → (n_ch, H*hop) time-domain block.
        """
        hop = self.hop
        _, w_syn = _windows(hop, self.low_delay)
        Y = Y.transpose(1, 2, 0)  # (n_ch, H, n_bands)
        if self.hybrid:
            Y = _hybrid_inverse(Y)  # (n_ch, H, hop+1)
        if self.low_delay:
            # Odd-bin sign flip == circular shift by hop samples
            # (afSTFT_internal.c:364-367).
            sign = jnp.asarray(np.where(np.arange(hop + 1) % 2, -1.0, 1.0),
                               dtype=Y.real.dtype)
            Y = Y * sign
        frame = irfft_op(Y, 2 * hop)  # 1/N-scaled
        y, tail = overlap_add(frame, state.ola_tail, w_syn, hop)
        return y, state._replace(ola_tail=tail)


def overlap_add(frame: jax.Array, ola_tail: jax.Array, w_syn: np.ndarray,
                hop: int):
    """Synthesis window ⊗ overlap-add of (..., H, 2·hop) irDFT frames onto
    the carried (..., 9·hop) tail → ((..., H·hop), new tail).

    Periodic extension × synthesis window: hop k of the 10-hop window takes
    the frame's (k % 2) half, and frame h's contribution lands on output hop
    h+k (afSTFT_internal.c:398-437).  Each contribution is zero-padded into
    place and summed (k ascending, then the tail), so the whole overlap-add
    is one fusible elementwise expression.  Shared by the complex and the
    split real/imaginary synthesis.
    """
    lead, H = frame.shape[:-2], frame.shape[-2]
    nt = _TOTAL_HOPS - 1
    w = jnp.asarray(w_syn, frame.dtype).reshape(_TOTAL_HOPS, hop)
    keep = [(0, 0)] * len(lead)
    acc = None
    for k in range(_TOTAL_HOPS):
        half = (k % 2) * hop
        term = jnp.pad(frame[..., half:half + hop] * w[k],
                       keep + [(k, nt - k), (0, 0)])
        acc = term if acc is None else acc + term
    flat = acc.reshape(lead + ((H + nt) * hop,))
    flat = flat + jnp.pad(ola_tail, keep + [(0, H * hop)])
    return flat[..., :H * hop], flat[..., H * hop:]


class AfSTFTState(NamedTuple):
    in_tail: jax.Array   # (n_ch_in, 9*hop) analysis ring-buffer tail
    hyb_tail: jax.Array  # (n_ch_in, 6, hop+1) hybrid-filter history
    ola_tail: jax.Array  # (n_ch_out, 9*hop) synthesis overlap-add tail


def _hybrid_forward(full: jax.Array, H: int) -> jax.Array:
    """Split bands 1–4 in two via half-band FIRs along hop-time.

    full: (n_ch, 6+H, hop+1) with 6 history frames in front.
    Returns (n_ch, H, hop+5).  afSTFT_internal.c:523-641.
    """
    d3 = full[:, 3 : 3 + H]  # group-delay-aligned main path (t-3)
    b = slice(1, 5)
    hb = 1j * (
        _COEFF1 * (full[:, 6 : 6 + H, b] - full[:, 0:H, b])
        + _COEFF2 * (full[:, 4 : 4 + H, b] - full[:, 2 : 2 + H, b])
    )
    c = 0.5 * d3[..., b]
    # Half-band order flips between odd/even source bands so hybrid bands come
    # out in ascending spectral order (afSTFT_internal.c:611-631).
    s = jnp.asarray(np.array([-1.0, 1.0, -1.0, 1.0]), dtype=full.real.dtype)
    lo = c + s * hb
    hi = c - s * hb
    pairs = jnp.stack([lo, hi], axis=-1).reshape(*lo.shape[:-1], 8)
    return jnp.concatenate([d3[..., :1], pairs, d3[..., 5:]], axis=-1)


def _hybrid_inverse(Y: jax.Array) -> jax.Array:
    """Merge hybrid band pairs back to uniform bands (afSTFT_internal.c:644-673).

    Y: (..., hop+5) → (..., hop+1).
    """
    pairs = Y[..., 1:9].reshape(*Y.shape[:-1], 4, 2).sum(-1)
    return jnp.concatenate([Y[..., :1], pairs, Y[..., 9:]], axis=-1)


def analyse(sig: np.ndarray, hop: int, low_delay: bool = False,
            hybrid: bool = True) -> np.ndarray:
    """One-shot analysis from zero state (``afAnalyse``, afSTFTlib.c:110-157).

    sig: (n_ch, n_samples) → (n_bands, n_ch, n_slots), n_slots = ceil(n/hop).
    """
    cfg = AfSTFT(hop=hop, hybrid=hybrid, low_delay=low_delay)
    n_ch, n = sig.shape
    n_slots = int(np.ceil(n / hop))
    buf = np.zeros((n_ch, n_slots * hop), np.float32)
    buf[:, :n] = sig
    # Design-time helper: run on host CPU (jitted) regardless of the default
    # accelerator — this is initCodec work, not the streaming path.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), force_dft_impl("fft"):
        st = cfg.init_state(n_ch, 1)
        out, _ = jax.jit(cfg.analysis)(st, jnp.asarray(buf))
        return np.asarray(out)


def fir_to_filterbank_coeffs(h_ir: np.ndarray, hop: int, low_delay: bool = False,
                             hybrid: bool = True) -> np.ndarray:
    """FIR filters → per-band complex filterbank coefficients.

    Equivalent of ``afSTFT_FIRtoFilterbankCoeffs`` (afSTFTlib.c:592-675):
    analyse each FIR and a centred unit impulse through the filterbank; the
    per-band coefficient has magnitude sqrt(E_fir/E_impulse) and the phase of
    the cross-correlation between the two subband responses.

    h_ir: (n_dirs, n_ch, ir_len) → (n_bands, n_ch, n_dirs) complex64.
    """
    n_dirs, n_ch, ir_len = h_ir.shape
    ir_pad = 1024
    T = max(ir_len, hop) + ir_pad

    # Mean (over channels) peak delay of direction 0, +1.5 (afSTFTlib.c:618-634).
    idx_del = int(np.mean(np.argmax(h_ir[0], axis=-1)) + 1.5)
    center = np.zeros((1, T), np.float32)
    center[0, idx_del] = 1.0
    D = analyse(center, hop, low_delay, hybrid)[:, 0]  # (n_bands, n_slots)
    d_energy = np.maximum((np.abs(D) ** 2).sum(-1), 2.23e-8)

    sig = np.zeros((n_dirs * n_ch, T), np.float32)
    sig[:, :ir_len] = h_ir.reshape(n_dirs * n_ch, ir_len)
    X = analyse(sig, hop, low_delay, hybrid)  # (n_bands, n_dirs*n_ch, n_slots)

    gain = np.sqrt((np.abs(X) ** 2).sum(-1) / d_energy[:, None])
    cross = np.einsum("bct,bt->bc", X, D.conj())
    g = gain * np.exp(1j * np.angle(cross))
    return (g.reshape(-1, n_dirs, n_ch).transpose(0, 2, 1)).astype(np.complex64)
