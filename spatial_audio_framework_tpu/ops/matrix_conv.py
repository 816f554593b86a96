"""FFT-domain convolution engines (counterpart of ``saf_utility_matrixConv``).

* ``MatrixConv`` — nCHout×nCHin filter matrix, uniformly-partitioned (default)
  or non-partitioned overlap-add (saf_utility_matrixConv.c:50-235).
* ``MultiConv`` — one filter per channel (saf_utility_matrixConv.c:237-437).
* ``TVConv``   — time-varying partitioned convolution with linear crossfade
  between filter sets on position change (saf_utility_matrixConv.c:439-660).

Design: filters are pre-FFT'd into a stacked partition tensor at
design time; each hop is ONE batched complex einsum over
(partitions × out × in × bins), and whole blocks of hops are processed at
once by stacking shifted views of the input-spectra ring (the "sequence
parallel" analogue of the reference's per-hop ring buffer).  State is an
explicit pytree; everything jits and vmaps over streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.ops.fft import irfft_op, rfft_op
from spatial_audio_framework_tpu.ops import precision as _prec


# natively-batched MatrixConv RI dispatches at or above this many instances
# use the grouped-conv spectral core instead of the sliding-window einsum
# (threshold tuned on an earlier accelerator, not measured on the H100;
# see MatrixConv._conv_core_ri)
_CONV_CORE_MIN_BATCH = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def partition_filters(H: np.ndarray, hop: int) -> np.ndarray:
    """(..., length_h) filters → (..., P, hop+1) partition spectra, where
    P = ceil(length_h / hop); each hop-length segment is zero-padded to
    2·hop and rFFT'd (saf_utility_matrixConv.c:100-130)."""
    length_h = H.shape[-1]
    P = _cdiv(length_h, hop)
    pad = np.zeros(H.shape[:-1] + (P * hop,), np.float32)
    pad[..., :length_h] = H
    seg = pad.reshape(H.shape[:-1] + (P, hop))
    seg = np.concatenate([seg, np.zeros_like(seg)], axis=-1)  # zero-pad to 2*hop
    return np.fft.rfft(seg, axis=-1).astype(np.complex64)


# ---------------------------------------------------------------------------
# MatrixConv
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MatrixConv:
    hop: int
    length_h: int
    n_in: int
    n_out: int
    partitioned: bool = True

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    @property
    def fft_size(self) -> int:
        if self.partitioned:
            return 2 * self.hop
        return _cdiv(self.hop + self.length_h - 1, self.hop) * self.hop

    def design(self, H: np.ndarray) -> jax.Array:
        """H: (n_out, n_in, length_h).  → partitioned: (P, n_out, n_in, hop+1)
        complex64; non-partitioned: (n_out, n_in, nBins)."""
        assert H.shape == (self.n_out, self.n_in, self.length_h)
        if self.partitioned:
            Hp = partition_filters(H, self.hop)  # (n_out, n_in, P, hop+1)
            return jnp.asarray(Hp.transpose(2, 0, 1, 3))
        Hf = np.fft.rfft(H, n=self.fft_size, axis=-1).astype(np.complex64)
        return jnp.asarray(Hf)

    def init_state(self, batch: tuple = ()) -> "MatrixConvState":
        if self.partitioned:
            X = jnp.zeros(batch + (self.n_part - 1, self.n_in, self.hop + 1),
                          jnp.complex64)
            ola = jnp.zeros(batch + (self.n_out, self.hop), jnp.float32)
        else:
            X = jnp.zeros(batch + (0, self.n_in, self.fft_size // 2 + 1),
                          jnp.complex64)
            ola = jnp.zeros(batch + (self.n_out, self.fft_size), jnp.float32)
        return MatrixConvState(X_hist=X, ola=ola)

    def apply_block(self, Hf: jax.Array, state: "MatrixConvState",
                    x: jax.Array):
        """x: (n_in, T), T = H·hop → ((n_out, T), state).  All hops in the
        block are processed as one einsum."""
        hop = self.hop
        T = x.shape[-1]
        nh = T // hop
        if self.partitioned:
            hp = _prec.HOT  # per-block path: same mode as the RI paths
            seg = x.reshape(self.n_in, nh, hop).transpose(1, 0, 2)
            S = rfft_op(seg, 2 * hop, precision=hp)  # (nh, n_in, hop+1)
            full = jnp.concatenate([state.X_hist, S], axis=0)  # (P-1+nh, ...)
            P = self.n_part
            # windows[t, k] = spectrum of hop (t - k): k=0 → current
            win = jnp.stack([full[P - 1 - k : P - 1 - k + nh] for k in range(P)],
                            axis=1)  # (nh, P, n_in, bins)
            Y = jnp.einsum("tpib,poib->tob", win, Hf, precision=hp)
            z = irfft_op(Y, 2 * hop, precision=hp)  # (nh, n_out, 2*hop)
            heads = z[..., :hop]
            tails = z[..., hop:]
            prev_tails = jnp.concatenate([state.ola[None], tails[:-1]], axis=0)
            out = heads + prev_tails  # (nh, n_out, hop)
            new_state = MatrixConvState(X_hist=full[nh:], ola=tails[-1])
            return out.transpose(1, 0, 2).reshape(self.n_out, T), new_state
        # non-partitioned: sequential overlap-add over hops (lax.scan)
        nfft = self.fft_size
        nblk = nfft // hop

        def step(ola, xh):  # xh: (n_in, hop)
            hp = _prec.HOT  # per-block path: same mode as the RI paths
            X = rfft_op(xh, nfft, precision=hp)
            Y = jnp.einsum("oib,ib->ob", Hf, X, precision=hp)
            z = irfft_op(Y, nfft, precision=hp)
            ola = jnp.concatenate(
                [ola[:, hop:], jnp.zeros((self.n_out, hop), ola.dtype)], -1)
            ola = ola + z
            return ola, ola[:, :hop]

        xh = x.reshape(self.n_in, nh, hop).transpose(1, 0, 2)
        ola, outs = jax.lax.scan(step, state.ola, xh)
        out = outs.transpose(1, 0, 2).reshape(self.n_out, T)
        del nblk
        return out, MatrixConvState(X_hist=state.X_hist, ola=ola)


    # -- split real/imaginary variant (no complex64 in the graph; see
    #    ops.afstft_ri for the rationale) — partitioned mode only ----------

    def design_ri(self, H: np.ndarray):
        """H: (n_out, n_in, length_h) → (Hre, Him) each (P, n_out, n_in,
        hop+1) float32 (host split — no complex device arrays)."""
        assert self.partitioned, "RI path implements the partitioned mode"
        assert H.shape == (self.n_out, self.n_in, self.length_h)
        Hp = partition_filters(H, self.hop).transpose(2, 0, 1, 3)
        return (jnp.asarray(Hp.real.astype(np.float32)),
                jnp.asarray(Hp.imag.astype(np.float32)))

    def init_state_ri(self, batch: tuple = ()) -> "MatrixConvState":
        assert self.partitioned
        X = jnp.zeros(batch + (self.n_part - 1, self.n_in,
                               2 * (self.hop + 1)), jnp.float32)
        ola = jnp.zeros(batch + (self.n_out, self.hop), jnp.float32)
        return MatrixConvState(X_hist=X, ola=ola)

    def _conv_core_ri(self, Hre, Him, full, nh: int, bshape: tuple):
        """Grouped-conv spectral MAC: full (..., nh+P-1, n_in, 2·nb) →
        (Yre, Yim) each (..., nh, n_out, nb).  Exactly the einsum core's
        sums (Σ_p Σ_i win·H with the same re/im combinations), expressed
        as a bins-grouped 1-D conv so the MAC streams the spectra once."""
        hop = self.hop
        nb = hop + 1
        P = self.n_part
        hp = _prec.HOT
        # kernel (P, n_in·2, nb·n_out·2): tap p holds partition P-1-p
        base_re = jnp.transpose(Hre[::-1], (0, 2, 3, 1))   # (P, i, b, o)
        base_im = jnp.transpose(Him[::-1], (0, 2, 3, 1))
        K = jnp.stack([jnp.stack([base_re, base_im], axis=-1),
                       jnp.stack([-base_im, base_re], axis=-1)],
                      axis=2)                    # (P, i, in_ri, b, o, o_ri)
        K = K.reshape(P, self.n_in * 2, nb * self.n_out * 2)
        nhp = full.shape[-3]
        fre, fim = full[..., :nb], full[..., nb:]
        xin = jnp.stack([fre, fim], axis=-1)     # (..., nh', i, nb, 2)
        xin = jnp.moveaxis(xin, -2, -3)          # (..., nh', nb, i, 2)
        xin = xin.reshape((-1, nhp, nb * self.n_in * 2))
        out = jax.lax.conv_general_dilated(
            xin, K, window_strides=(1,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"),
            feature_group_count=nb, precision=hp)
        out = out.reshape(bshape + (nh, nb, self.n_out, 2))
        return (jnp.swapaxes(out[..., 0], -1, -2),
                jnp.swapaxes(out[..., 1], -1, -2))

    def apply_block_ri(self, H_ri, state: "MatrixConvState", x: jax.Array):
        """apply_block on packed [re | im] float32 spectra: H_ri = (Hre, Him)
        from design_ri; X_hist carries (..., P-1, n_in, 2·(hop+1)).

        Batch-tolerant: x (..., n_in, T) with state from
        init_state_ri(batch=x.shape[:-2]) runs independent convolver
        instances in one dispatch."""
        from spatial_audio_framework_tpu.ops.fft import _rdft_mats

        assert self.partitioned
        hop = self.hop
        hp = _prec.HOT  # per-block path: 3-pass f32x3 (ops/precision.py)
        Hre, Him = H_ri
        T = x.shape[-1]
        nh = T // hop
        nb = hop + 1
        C, Sm, A, B = _rdft_mats(2 * hop)
        bshape = x.shape[:-2]
        seg = x.reshape(bshape + (self.n_in, nh, hop))
        segp = jnp.concatenate([seg, jnp.zeros_like(seg)], axis=-1)
        S_p = jnp.concatenate(
            [jnp.matmul(segp, jnp.asarray(C), precision=hp),
             jnp.matmul(segp, jnp.asarray(Sm), precision=hp)],
            axis=-1)                                  # (..., n_in, nh, 2nb)
        full = jnp.concatenate([state.X_hist,
                                jnp.moveaxis(S_p, -2, -3)], axis=-3)
        P = self.n_part
        if int(np.prod(bshape, dtype=np.int64)) >= _CONV_CORE_MIN_BATCH:
            # many-instance core: the spectral MAC runs as ONE grouped 1-D
            # convolution over the hop axis (groups = bins; per group a
            # (n_in·2 → n_out·2) re/im mixing kernel, partitions reversed
            # into conv taps).  No (nh, P, n_in, bins) sliding-window
            # stack is materialised; below _CONV_CORE_MIN_BATCH instances
            # the einsum core is used.
            Yre, Yim = self._conv_core_ri(Hre, Him, full, nh, bshape)
        else:
            win = jnp.stack([full[..., P - 1 - k: P - 1 - k + nh, :, :]
                             for k in range(P)],
                            axis=-3)                  # (..., nh, P, i, 2nb)
            wre, wim = win[..., :nb], win[..., nb:]
            Yre = (jnp.einsum("...tpib,poib->...tob", wre, Hre,
                              precision=hp)
                   - jnp.einsum("...tpib,poib->...tob", wim, Him,
                                precision=hp))
            Yim = (jnp.einsum("...tpib,poib->...tob", wre, Him,
                              precision=hp)
                   + jnp.einsum("...tpib,poib->...tob", wim, Hre,
                                precision=hp))
        z = (jnp.matmul(Yre, jnp.asarray(A), precision=hp)
             + jnp.matmul(Yim, jnp.asarray(B), precision=hp))
        heads = z[..., :hop]                          # (..., nh, o, hop)
        tails = z[..., hop:]
        prev_tails = jnp.concatenate([state.ola[..., None, :, :],
                                      tails[..., :-1, :, :]], axis=-3)
        out = heads + prev_tails
        new_state = MatrixConvState(X_hist=full[..., nh:, :, :],
                                    ola=tails[..., -1, :, :])
        return (jnp.moveaxis(out, -2, -3).reshape(
            bshape + (self.n_out, T)), new_state)


class MatrixConvState(NamedTuple):
    X_hist: jax.Array  # (P-1, n_in, bins) past input spectra (oldest first)
    ola: jax.Array     # overlap tail


# ---------------------------------------------------------------------------
# MultiConv — per-channel filters (no matrixing)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MultiConv:
    hop: int
    length_h: int
    n_ch: int
    partitioned: bool = True

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    def design(self, H: np.ndarray) -> jax.Array:
        """H: (n_ch, length_h) → (P, n_ch, hop+1) complex64 (partitioned) or
        (n_ch, nBins)."""
        assert H.shape == (self.n_ch, self.length_h)
        if self.partitioned:
            return jnp.asarray(partition_filters(H, self.hop).transpose(1, 0, 2))
        nfft = _cdiv(self.hop + self.length_h - 1, self.hop) * self.hop
        return jnp.asarray(np.fft.rfft(H, n=nfft, axis=-1).astype(np.complex64))

    def init_state(self, batch: tuple = ()) -> MatrixConvState:
        if self.partitioned:
            X = jnp.zeros(batch + (self.n_part - 1, self.n_ch, self.hop + 1),
                          jnp.complex64)
            ola = jnp.zeros(batch + (self.n_ch, self.hop), jnp.float32)
        else:
            nfft = _cdiv(self.hop + self.length_h - 1, self.hop) * self.hop
            X = jnp.zeros(batch + (0, self.n_ch, nfft // 2 + 1), jnp.complex64)
            ola = jnp.zeros(batch + (self.n_ch, nfft), jnp.float32)
        return MatrixConvState(X_hist=X, ola=ola)

    def apply_block(self, Hf: jax.Array, state: MatrixConvState, x: jax.Array):
        """x: (n_ch, T) → ((n_ch, T), state)."""
        hop = self.hop
        T = x.shape[-1]
        nh = T // hop
        if self.partitioned:
            hp = _prec.HOT  # per-block path: same mode as the RI paths
            seg = x.reshape(self.n_ch, nh, hop).transpose(1, 0, 2)
            S = rfft_op(seg, 2 * hop, precision=hp)
            full = jnp.concatenate([state.X_hist, S], axis=0)
            P = self.n_part
            win = jnp.stack([full[P - 1 - k : P - 1 - k + nh] for k in range(P)],
                            axis=1)  # (nh, P, n_ch, bins)
            Y = jnp.einsum("tpcb,pcb->tcb", win, Hf, precision=hp)
            z = irfft_op(Y, 2 * hop, precision=hp)
            heads, tails = z[..., :hop], z[..., hop:]
            prev_tails = jnp.concatenate([state.ola[None], tails[:-1]], axis=0)
            out = heads + prev_tails
            return (out.transpose(1, 0, 2).reshape(self.n_ch, T),
                    MatrixConvState(X_hist=full[nh:], ola=tails[-1]))
        nfft = state.ola.shape[-1]

        def step(ola, xh):
            hp = _prec.HOT  # per-block path: same mode as the RI paths
            X = rfft_op(xh, nfft, precision=hp)
            z = irfft_op(Hf * X, nfft, precision=hp)
            ola = jnp.concatenate(
                [ola[:, hop:], jnp.zeros((self.n_ch, hop), ola.dtype)], -1)
            ola = ola + z
            return ola, ola[:, :hop]

        xh = x.reshape(self.n_ch, nh, hop).transpose(1, 0, 2)
        ola, outs = jax.lax.scan(step, state.ola, xh)
        return (outs.transpose(1, 0, 2).reshape(self.n_ch, T),
                MatrixConvState(X_hist=state.X_hist, ola=ola))

    # -- split real/imaginary variant (partitioned mode) ---------------------

    def design_ri(self, H: np.ndarray):
        assert self.partitioned and H.shape == (self.n_ch, self.length_h)
        Hp = partition_filters(H, self.hop).transpose(1, 0, 2)
        return (jnp.asarray(Hp.real.astype(np.float32)),
                jnp.asarray(Hp.imag.astype(np.float32)))

    def init_state_ri(self, batch: tuple = ()) -> MatrixConvState:
        assert self.partitioned
        return MatrixConvState(
            X_hist=jnp.zeros(batch + (self.n_part - 1, self.n_ch,
                                      2 * (self.hop + 1)), jnp.float32),
            ola=jnp.zeros(batch + (self.n_ch, self.hop), jnp.float32))

    def apply_block_ri(self, H_ri, state: MatrixConvState, x: jax.Array):
        from spatial_audio_framework_tpu.ops.fft import _rdft_mats

        assert self.partitioned
        hop = self.hop
        hp = _prec.HOT  # per-block path: 3-pass f32x3 (ops/precision.py)
        Hre, Him = H_ri
        T = x.shape[-1]
        nh = T // hop
        nb = hop + 1
        C, Sm, A, B = _rdft_mats(2 * hop)
        seg = x.reshape(self.n_ch, nh, hop).transpose(1, 0, 2)
        segp = jnp.concatenate([seg, jnp.zeros_like(seg)], axis=-1)
        S_p = jnp.concatenate(
            [jnp.matmul(segp, jnp.asarray(C), precision=hp),
             jnp.matmul(segp, jnp.asarray(Sm), precision=hp)], axis=-1)
        full = jnp.concatenate([state.X_hist, S_p], axis=0)
        P = self.n_part
        win = jnp.stack([full[P - 1 - k: P - 1 - k + nh] for k in range(P)],
                        axis=1)
        wre, wim = win[..., :nb], win[..., nb:]
        Yre = (jnp.einsum("tpcb,pcb->tcb", wre, Hre, precision=hp)
               - jnp.einsum("tpcb,pcb->tcb", wim, Him, precision=hp))
        Yim = (jnp.einsum("tpcb,pcb->tcb", wre, Him, precision=hp)
               + jnp.einsum("tpcb,pcb->tcb", wim, Hre, precision=hp))
        z = (jnp.matmul(Yre, jnp.asarray(A), precision=hp)
             + jnp.matmul(Yim, jnp.asarray(B), precision=hp))
        heads, tails = z[..., :hop], z[..., hop:]
        prev_tails = jnp.concatenate([state.ola[None], tails[:-1]], axis=0)
        out = heads + prev_tails
        return (out.transpose(1, 0, 2).reshape(self.n_ch, T),
                MatrixConvState(X_hist=full[nh:], ola=tails[-1]))


# ---------------------------------------------------------------------------
# TVConv — time-varying partitioned convolution with crossfade
# ---------------------------------------------------------------------------

class TVConvState(NamedTuple):
    X_hist: jax.Array       # (P-1, bins) past input spectra (oldest first)
    ola: jax.Array          # (n_out, hop) overlap of current filter set
    ola_last: jax.Array     # (n_out, hop) overlap of previous filter set
    pos_last: jax.Array     # () int32
    pos_last2: jax.Array    # () int32


@dataclass(frozen=True)
class TVConv:
    """Single input channel → n_out outputs, one filter set per listener
    position, crossfading on position change (saf_utility_matrixConv.c:548)."""
    hop: int
    length_h: int
    n_out: int
    n_irs: int

    @property
    def n_part(self) -> int:
        return _cdiv(self.length_h, self.hop)

    def design(self, H: np.ndarray) -> jax.Array:
        """H: (n_irs, n_out, length_h) → (n_irs, P, n_out, hop+1) complex64."""
        assert H.shape == (self.n_irs, self.n_out, self.length_h)
        Hp = partition_filters(H, self.hop)  # (n_irs, n_out, P, bins)
        return jnp.asarray(Hp.transpose(0, 2, 1, 3))

    def init_state(self, init_idx: int = 0, batch: tuple = ()) -> TVConvState:
        idx = init_idx if init_idx < self.n_irs else 0
        return TVConvState(
            X_hist=jnp.zeros(batch + (self.n_part - 1, self.hop + 1), jnp.complex64),
            ola=jnp.zeros(batch + (self.n_out, self.hop), jnp.float32),
            ola_last=jnp.zeros(batch + (self.n_out, self.hop), jnp.float32),
            pos_last=jnp.full(batch, idx, jnp.int32),
            pos_last2=jnp.full(batch, idx, jnp.int32))

    def apply_hop(self, Hf: jax.Array, state: TVConvState, x: jax.Array,
                  ir_idx: jax.Array):
        """One hop (saf_TVConv_apply).  x: (hop,); ir_idx: () int32 traced.
        → ((n_out, hop), state)."""
        hop = self.hop
        hp = _prec.HOT  # per-block path: same mode as the RI paths
        X = rfft_op(x, 2 * hop, precision=hp)  # (bins,)
        full = jnp.concatenate([state.X_hist, X[None]], axis=0)  # (P, bins)
        win = full[::-1]  # win[k] = spectrum k hops ago

        def conv_with(idx):
            Y = jnp.einsum("pob,pb->ob", jnp.take(Hf, idx, axis=0), win,
                           precision=hp)
            return irfft_op(Y, 2 * hop, precision=hp)  # (n_out, 2*hop)

        z = conv_with(ir_idx)
        z_last = jnp.where((ir_idx != state.pos_last)[..., None, None],
                           conv_with(state.pos_last), z)
        z_last2 = jnp.where((state.pos_last != state.pos_last2)[..., None, None],
                            conv_with(state.pos_last2), z_last)
        out1 = z_last[..., :hop] + state.ola
        out2 = z_last2[..., :hop] + state.ola_last
        n = jnp.arange(hop, dtype=x.dtype)
        fade_in = n / (hop - 1.0)
        out = out1 * fade_in + out2 * (1.0 - fade_in)
        new_state = TVConvState(X_hist=full[1:], ola=z[..., hop:],
                                ola_last=z_last[..., hop:],
                                pos_last=jnp.asarray(ir_idx, jnp.int32),
                                pos_last2=state.pos_last)
        return out, new_state

    @staticmethod
    def _idx_streams(state: TVConvState, ir_idx: jax.Array):
        """Vectorised crossfade index recurrences: the sequential carry
        pos_last/pos_last2 are pure shifts of the per-hop index stream.
        Batch-tolerant: ir_idx (..., nh), pos_last* (...,)."""
        idx0 = jnp.asarray(ir_idx, jnp.int32)
        idx1 = jnp.concatenate([state.pos_last[..., None],
                                idx0[..., :-1]], axis=-1)
        idx2 = jnp.concatenate([state.pos_last2[..., None],
                                idx1[..., :-1]], axis=-1)
        return idx0, idx1, idx2

    def _xfade_combine(self, state: TVConvState, z0, z_last, z_last2,
                      idx0, idx1, x_dtype):
        """Shared OLA + crossfade tail of both block paths.  z*: (..., nh,
        n_out, 2·hop); the per-hop OLA carries are shifts of the batched
        tails."""
        hop = self.hop
        prev0 = jnp.concatenate([state.ola[..., None, :, :],
                                 z0[..., :-1, :, hop:]], axis=-3)
        prev_l = jnp.concatenate([state.ola_last[..., None, :, :],
                                  z_last[..., :-1, :, hop:]], axis=-3)
        out1 = z_last[..., :hop] + prev0
        out2 = z_last2[..., :hop] + prev_l
        n = jnp.arange(hop, dtype=x_dtype)
        fade_in = n / (hop - 1.0)
        out = out1 * fade_in + out2 * (1.0 - fade_in)
        new_state_tail = dict(ola=z0[..., -1, :, hop:],
                              ola_last=z_last[..., -1, :, hop:],
                              pos_last=idx0[..., -1], pos_last2=idx1[..., -1])
        return out, new_state_tail

    @staticmethod
    def _xfade_streams(conv_all, z0, idx0, idx1, idx2):
        """The two crossfade conv streams, or ``z0`` pass-throughs when NO
        index changed anywhere in the block (a static listener).  The
        whole-block predicate is scalar even for batched states, so
        ``lax.cond`` genuinely skips the two extra convolutions — the C
        engine likewise only convolves with previous filter sets on a
        position change (saf_utility_matrixConv.c:548 saf_TVConv_apply);
        the per-hop ``where`` selects reproduce its hop-exact crossfade
        when it does fire."""
        changed = jnp.any(idx0 != idx1) | jnp.any(idx1 != idx2)

        def with_xfade(_):
            z_last = jnp.where((idx0 != idx1)[..., None, None],
                               conv_all(idx1), z0)
            z_last2 = jnp.where((idx1 != idx2)[..., None, None],
                                conv_all(idx2), z_last)
            return z_last, z_last2

        return jax.lax.cond(changed, with_xfade, lambda _: (z0, z0), None)

    def apply_block(self, Hf: jax.Array, state: TVConvState, x: jax.Array,
                    ir_idx: jax.Array):
        """x: (..., T) with one position index per hop: ir_idx (..., nh)
        int32; state from init_state(batch=x.shape[:-1]).

        Batched (no scan): all hop spectra at once, sliding spectral windows,
        and the three crossfade conv streams as gathered einsums — the
        sequential pos_last/ola carries are shifts of batched arrays.
        Leading batch dims run any number of independent convolver
        instances in one dispatch."""
        hop = self.hop
        hp = _prec.HOT  # per-block path: same mode as the RI paths
        nh = x.shape[-1] // hop
        P = self.n_part
        bshape = x.shape[:-1]
        S = rfft_op(x.reshape(bshape + (nh, hop)), 2 * hop,
                    precision=hp)                      # (..., nh, bins)
        full = jnp.concatenate([state.X_hist, S], axis=-2)
        # win[t, k] = spectrum of hop (t - k)
        win = jnp.stack([full[..., P - 1 - k: P - 1 - k + nh, :]
                         for k in range(P)], axis=-2)  # (..., nh, P, bins)
        idx0, idx1, idx2 = self._idx_streams(state, ir_idx)

        def conv_all(idx):
            Y = jnp.einsum("...tpob,...tpb->...tob",
                           jnp.take(Hf, idx, axis=0), win, precision=hp)
            return irfft_op(Y, 2 * hop, precision=hp)  # (..., nh, o, 2*hop)

        z0 = conv_all(idx0)
        z_last, z_last2 = self._xfade_streams(conv_all, z0, idx0, idx1, idx2)
        out, tail = self._xfade_combine(state, z0, z_last, z_last2,
                                        idx0, idx1, x.dtype)
        state = TVConvState(X_hist=full[..., nh:, :], **tail)
        return (jnp.moveaxis(out, -2, -3).reshape(
            bshape + (self.n_out, nh * hop)), state)

    # -- split real/imaginary variant -----------------------------------------

    def design_ri(self, H: np.ndarray):
        assert H.shape == (self.n_irs, self.n_out, self.length_h)
        Hp = partition_filters(H, self.hop).transpose(0, 2, 1, 3)
        return (jnp.asarray(Hp.real.astype(np.float32)),
                jnp.asarray(Hp.imag.astype(np.float32)))

    def init_state_ri(self, init_idx: int = 0,
                      batch: tuple = ()) -> TVConvState:
        idx = init_idx if init_idx < self.n_irs else 0
        return TVConvState(
            X_hist=jnp.zeros(batch + (self.n_part - 1, 2 * (self.hop + 1)),
                             jnp.float32),
            ola=jnp.zeros(batch + (self.n_out, self.hop), jnp.float32),
            ola_last=jnp.zeros(batch + (self.n_out, self.hop), jnp.float32),
            pos_last=jnp.full(batch, idx, jnp.int32),
            pos_last2=jnp.full(batch, idx, jnp.int32))

    def apply_hop_ri(self, H_ri, state: TVConvState, x: jax.Array,
                     ir_idx: jax.Array):
        """apply_hop on packed [re | im] spectra (complex-free graph)."""
        from spatial_audio_framework_tpu.ops.fft import _rdft_mats

        hop = self.hop
        nb = hop + 1
        hp = _prec.HOT  # per-block path: 3-pass f32x3 (ops/precision.py)
        Hre, Him = H_ri
        C, Sm, A, B = _rdft_mats(2 * hop)
        xp = jnp.concatenate([x, jnp.zeros_like(x)], axis=-1)
        Xp = jnp.concatenate(
            [jnp.matmul(xp, jnp.asarray(C), precision=hp),
             jnp.matmul(xp, jnp.asarray(Sm), precision=hp)], axis=-1)
        full = jnp.concatenate([state.X_hist, Xp[None]], axis=0)
        win = full[::-1]
        wre, wim = win[..., :nb], win[..., nb:]

        def conv_with(idx):
            hre = jnp.take(Hre, idx, axis=0)
            him = jnp.take(Him, idx, axis=0)
            Yre = (jnp.einsum("pob,pb->ob", hre, wre, precision=hp)
                   - jnp.einsum("pob,pb->ob", him, wim, precision=hp))
            Yim = (jnp.einsum("pob,pb->ob", him, wre, precision=hp)
                   + jnp.einsum("pob,pb->ob", hre, wim, precision=hp))
            return (jnp.matmul(Yre, jnp.asarray(A), precision=hp)
                    + jnp.matmul(Yim, jnp.asarray(B), precision=hp))

        z = conv_with(ir_idx)
        z_last = jnp.where((ir_idx != state.pos_last)[..., None, None],
                           conv_with(state.pos_last), z)
        z_last2 = jnp.where((state.pos_last != state.pos_last2)[..., None, None],
                            conv_with(state.pos_last2), z_last)
        out1 = z_last[..., :hop] + state.ola
        out2 = z_last2[..., :hop] + state.ola_last
        n = jnp.arange(hop, dtype=x.dtype)
        fade_in = n / (hop - 1.0)
        out = out1 * fade_in + out2 * (1.0 - fade_in)
        new_state = TVConvState(X_hist=full[1:], ola=z[..., hop:],
                                ola_last=z_last[..., hop:],
                                pos_last=jnp.asarray(ir_idx, jnp.int32),
                                pos_last2=state.pos_last)
        return out, new_state

    def apply_block_ri_const(self, H_ri, state: TVConvState, x: jax.Array,
                             ir_idx: jax.Array):
        """apply_block_ri when the position is CONSTANT across the block —
        one index per call, the tvconv example's contract (the C likewise
        looks the filter up once per process call,
        tvconv_internal ``tvconv_findNearestNeigbour``).  x: (..., T),
        ir_idx: (...,) int32.

        Exactly the values of ``apply_block_ri`` with a broadcast index:
        filters are gathered ONCE per call instead of per hop, the block
        convolution is one einsum, and the crossfade streams differ from
        it only in their first one/two hops (where the previous filter
        sets apply) — built by splicing single-hop convolutions, inside a
        whole-block ``lax.cond`` that skips them when nothing changed.
        The splice is exact even when some indices coincide (equal
        filters give equal rows)."""
        from spatial_audio_framework_tpu.ops.fft import _rdft_mats

        hop = self.hop
        nb = hop + 1
        hp = _prec.HOT
        Hre, Him = H_ri
        nh = x.shape[-1] // hop
        P = self.n_part
        bshape = x.shape[:-1]
        if nh < 2:
            return self.apply_block_ri(
                H_ri, state, x, jnp.broadcast_to(
                    jnp.asarray(ir_idx, jnp.int32)[..., None],
                    bshape + (nh,)))
        C, Sm, A, B = _rdft_mats(2 * hop)
        seg = x.reshape(bshape + (nh, hop))
        segp = jnp.concatenate([seg, jnp.zeros_like(seg)], axis=-1)
        S_p = jnp.concatenate(
            [jnp.matmul(segp, jnp.asarray(C), precision=hp),
             jnp.matmul(segp, jnp.asarray(Sm), precision=hp)], axis=-1)
        full = jnp.concatenate([state.X_hist, S_p], axis=-2)
        win = jnp.stack([full[..., P - 1 - k: P - 1 - k + nh, :]
                         for k in range(P)], axis=-2)  # (..., nh, P, 2·nb)
        wre, wim = win[..., :nb], win[..., nb:]
        idxc = jnp.asarray(ir_idx, jnp.int32)

        def conv_with(idx, wre_, wim_):
            hre = jnp.take(Hre, idx, axis=0)           # (..., P, n_out, nb)
            him = jnp.take(Him, idx, axis=0)
            Yre = (jnp.einsum("...pob,...tpb->...otb", hre, wre_,
                              precision=hp)
                   - jnp.einsum("...pob,...tpb->...otb", him, wim_,
                                precision=hp))
            Yim = (jnp.einsum("...pob,...tpb->...otb", him, wre_,
                              precision=hp)
                   + jnp.einsum("...pob,...tpb->...otb", hre, wim_,
                                precision=hp))
            return (jnp.matmul(Yre, jnp.asarray(A), precision=hp)
                    + jnp.matmul(Yim, jnp.asarray(B), precision=hp))

        z0 = conv_with(idxc, wre, wim)             # (..., n_out, nh, 2·hop)
        changed = (jnp.any(idxc != state.pos_last)
                   | jnp.any(state.pos_last != state.pos_last2))

        def with_xfade(_):
            r0_last = conv_with(state.pos_last,
                                wre[..., :1, :, :], wim[..., :1, :, :])
            r0_last2 = conv_with(state.pos_last2,
                                 wre[..., :1, :, :], wim[..., :1, :, :])
            r1_last = conv_with(state.pos_last,
                                wre[..., 1:2, :, :], wim[..., 1:2, :, :])
            zl = jnp.concatenate([r0_last, z0[..., 1:, :]], axis=-2)
            zl2 = jnp.concatenate([r0_last2, r1_last, z0[..., 2:, :]],
                                  axis=-2)
            return zl, zl2

        z_last, z_last2 = jax.lax.cond(changed, with_xfade,
                                       lambda _: (z0, z0), None)
        prev0 = jnp.concatenate([state.ola[..., :, None, :],
                                 z0[..., :-1, hop:]], axis=-2)
        prev_l = jnp.concatenate([state.ola_last[..., :, None, :],
                                  z_last[..., :-1, hop:]], axis=-2)
        out1 = z_last[..., :hop] + prev0
        out2 = z_last2[..., :hop] + prev_l
        n = jnp.arange(hop, dtype=x.dtype)
        fade_in = n / (hop - 1.0)
        out = out1 * fade_in + out2 * (1.0 - fade_in)
        pl_new = jnp.broadcast_to(idxc, bshape)
        state = TVConvState(X_hist=full[..., nh:, :],
                            ola=z0[..., -1, hop:],
                            ola_last=z_last[..., -1, hop:],
                            pos_last=pl_new, pos_last2=pl_new)
        return out.reshape(bshape + (self.n_out, nh * hop)), state

    def apply_block_ri(self, H_ri, state: TVConvState, x: jax.Array,
                       ir_idx: jax.Array):
        """Batched complex-free block path (see apply_block).  x: (..., T),
        ir_idx: (..., nh); leading batch dims run independent instances in
        one dispatch (state from init_state_ri(batch=x.shape[:-1]))."""
        from spatial_audio_framework_tpu.ops.fft import _rdft_mats

        hop = self.hop
        nb = hop + 1
        hp = _prec.HOT  # per-block path: 3-pass f32x3 (ops/precision.py)
        Hre, Him = H_ri
        nh = x.shape[-1] // hop
        P = self.n_part
        bshape = x.shape[:-1]
        C, Sm, A, B = _rdft_mats(2 * hop)
        seg = x.reshape(bshape + (nh, hop))
        segp = jnp.concatenate([seg, jnp.zeros_like(seg)], axis=-1)
        S_p = jnp.concatenate(
            [jnp.matmul(segp, jnp.asarray(C), precision=hp),
             jnp.matmul(segp, jnp.asarray(Sm), precision=hp)], axis=-1)
        full = jnp.concatenate([state.X_hist, S_p], axis=-2)
        win = jnp.stack([full[..., P - 1 - k: P - 1 - k + nh, :]
                         for k in range(P)], axis=-2)  # (..., nh, P, 2·nb)
        wre, wim = win[..., :nb], win[..., nb:]
        idx0, idx1, idx2 = self._idx_streams(state, ir_idx)

        def conv_all(idx):
            # output in (..., n_out, nh, bins) O-MAJOR layout: the hop
            # axis stays second-minor (full 64-row tiles) instead of a
            # 2-wide n_out axis padding every tile 4× — and the final
            # (n_out, T) reshape needs no transpose
            hre = jnp.take(Hre, idx, axis=0)       # (..., nh, P, n_out, nb)
            him = jnp.take(Him, idx, axis=0)
            Yre = (jnp.einsum("...tpob,...tpb->...otb", hre, wre,
                              precision=hp)
                   - jnp.einsum("...tpob,...tpb->...otb", him, wim,
                                precision=hp))
            Yim = (jnp.einsum("...tpob,...tpb->...otb", him, wre,
                              precision=hp)
                   + jnp.einsum("...tpob,...tpb->...otb", hre, wim,
                                precision=hp))
            return (jnp.matmul(Yre, jnp.asarray(A), precision=hp)
                    + jnp.matmul(Yim, jnp.asarray(B), precision=hp))

        def xfade_streams_om(z0):
            changed = jnp.any(idx0 != idx1) | jnp.any(idx1 != idx2)

            def with_xfade(_):
                zl = jnp.where((idx0 != idx1)[..., None, :, None],
                               conv_all(idx1), z0)
                zl2 = jnp.where((idx1 != idx2)[..., None, :, None],
                                conv_all(idx2), zl)
                return zl, zl2

            return jax.lax.cond(changed, with_xfade, lambda _: (z0, z0),
                                None)

        z0 = conv_all(idx0)                        # (..., n_out, nh, 2·hop)
        z_last, z_last2 = xfade_streams_om(z0)
        prev0 = jnp.concatenate([state.ola[..., :, None, :],
                                 z0[..., :-1, hop:]], axis=-2)
        prev_l = jnp.concatenate([state.ola_last[..., :, None, :],
                                  z_last[..., :-1, hop:]], axis=-2)
        out1 = z_last[..., :hop] + prev0
        out2 = z_last2[..., :hop] + prev_l
        n = jnp.arange(hop, dtype=x.dtype)
        fade_in = n / (hop - 1.0)
        out = out1 * fade_in + out2 * (1.0 - fade_in)
        state = TVConvState(X_hist=full[..., nh:, :],
                            ola=z0[..., -1, hop:],
                            ola_last=z_last[..., -1, hop:],
                            pos_last=idx0[..., -1], pos_last2=idx1[..., -1])
        return out.reshape(bshape + (self.n_out, nh * hop)), state
