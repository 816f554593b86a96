"""SMB phase-vocoder pitch shifter (counterpart of ``saf_utility_pitch``,
the classic smbPitchShift algorithm).

Functional state + lax.scan over STFT frames (the phase accumulators are a
true sequential dependency); each frame is windowed rFFT → phase-vocoder
reassignment (scatter-add over bins) → irFFT → overlap-add, all batched over
channels.  The pitch-shift factor is traced, so it can vary per block.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np



class SmbPitchShiftState(NamedTuple):
    in_fifo: jax.Array     # (nCH, N - step) input history
    out_accum: jax.Array   # (nCH, N) overlap-add accumulator
    last_phase: jax.Array  # (nCH, N//2+1)
    sum_phase: jax.Array   # (nCH, N//2+1)
    out_fifo: jax.Array    # (nCH, step) pending output (one-hop latency,
    #                        gOutFIFO in saf_utility_pitch.c:245 — hop j's
    #                        synthesis is emitted while hop j+1 is collected)


@dataclass(frozen=True)
class SmbPitchShift:
    fs: float = 48000.0
    n_ch: int = 1
    fft_size: int = 8192     # smb_pitchShift_create defaults (pitch_shifter.c)
    osamp: int = 16

    @property
    def step(self) -> int:
        return self.fft_size // self.osamp

    @property
    def latency(self) -> int:
        return self.fft_size - self.step

    def init_state(self) -> SmbPitchShiftState:
        N, half = self.fft_size, self.fft_size // 2 + 1
        return SmbPitchShiftState(
            in_fifo=jnp.zeros((self.n_ch, N - self.step), jnp.float32),
            out_accum=jnp.zeros((self.n_ch, N), jnp.float32),
            last_phase=jnp.zeros((self.n_ch, half), jnp.float32),
            sum_phase=jnp.zeros((self.n_ch, half), jnp.float32),
            out_fifo=jnp.zeros((self.n_ch, self.step), jnp.float32))

    @property
    def _ct_split(self):
        """N = N1·N2 factor split for the two-stage Cooley-Tukey DFT.
        fft_size must be a power of two (the C's smbFft has the same
        constraint)."""
        N = self.fft_size
        assert N > 0 and (N & (N - 1)) == 0, \
            f"fft_size must be a power of two, got {N}"
        n1 = 1 << (int(np.log2(N)) // 2)
        return n1, N // n1

    def design(self):
        """Two-stage Cooley-Tukey DFT operators (N = N1·N2), to pass into a
        jitted apply() as ARGUMENTS.

        The previous direct matmul-DFT operators were (N, N/2+1) dense —
        ~0.5 GB of constants at fft_size 8192 and 67M MACs per frame.  The
        factored stages are three small matmuls + a twiddle product
        (W1 (N1,N1), W2 (N2,N2), twiddles (N2,N1): <200 kB total, ~16×
        fewer FLOPs).  The synthesis inverse computes the C's one-sided
        unscaled IDFT real part U(n) = Re Σ_{k≤N/2} S_k e^{+i2πkn/N}
        DIRECTLY (no irfft + DC/Nyquist correction needed)."""
        N = self.fft_size
        N1, N2 = self._ct_split
        ang1 = 2.0 * np.pi * np.outer(np.arange(N1), np.arange(N1)) / N1
        ang2 = 2.0 * np.pi * np.outer(np.arange(N2), np.arange(N2)) / N2
        angT = 2.0 * np.pi * np.outer(np.arange(N2), np.arange(N1)) / N
        mats = (np.cos(ang1), -np.sin(ang1),          # W1  (forward e^{-i})
                np.cos(ang2), -np.sin(ang2),          # W2
                np.cos(angT), -np.sin(angT),          # twiddle T[n2, k1]
                np.cos(ang1), np.sin(ang1),           # W1i (inverse e^{+i})
                np.cos(ang2), np.sin(ang2),           # W2i
                np.cos(angT), np.sin(angT))           # Tinv[m2, k1]
        return tuple(jnp.asarray(m.astype(np.float32)) for m in mats)

    def apply(self, state: SmbPitchShiftState, x: jax.Array,
              shift_factor: jax.Array, mats=None):
        """x: (nCH, T) with T a multiple of step → ((nCH, T), state).
        mats: optional design() output; pass it through jit arguments when
        compiling for a remote device (see design())."""
        N, step, osamp = self.fft_size, self.step, self.osamp
        half = N // 2 + 1
        n_frames = x.shape[-1] // step
        win = jnp.asarray(-0.5 * np.cos(2.0 * np.pi * np.arange(N) / N) + 0.5,
                          jnp.float32)
        k = jnp.arange(half, dtype=jnp.float32)
        freq_per_bin = self.fs / N
        expct = 2.0 * jnp.pi * step / N
        if mats is None:
            mats = self.design()
        (W1c, W1s, W2c, W2s, Tc, Ts,
         W1ic, W1is, W2ic, W2is, Tic, Tis) = mats
        N1, N2 = self._ct_split
        hp = jax.lax.Precision.HIGHEST
        ein = partial(jnp.einsum, precision=hp)

        def frame_step(carry, x_hop):
            fifo, accum, last_ph, sum_ph, out_fifo = carry
            # emit the PREVIOUS frame's synthesis while collecting this hop
            # (the gOutFIFO one-hop latency, saf_utility_pitch.c:245)
            out_hop = out_fifo
            buf = jnp.concatenate([fifo, x_hop], axis=-1)  # (nCH, N)
            xw = buf * win
            # forward DFT via Cooley-Tukey (n = n1·N2 + n2, k = k1 + N1·k2):
            # inner DFT_N1 over n1, twiddle, outer DFT_N2 over n2
            xr = xw.reshape(-1, N1, N2)
            Gre = ein("cnm,nk->cmk", xr, W1c)
            Gim = ein("cnm,nk->cmk", xr, W1s)
            Hre = Gre * Tc - Gim * Ts
            Him = Gre * Ts + Gim * Tc
            # only bins k ≤ N/2 are consumed → emit only outer rows
            # k2 ≤ N2/2 (k = k2·N1 + k1)
            h2 = N2 // 2 + 1
            Ore = (ein("cmk,mp->cpk", Hre, W2c[:, :h2])
                   - ein("cmk,mp->cpk", Him, W2s[:, :h2]))
            Oim = (ein("cmk,mp->cpk", Hre, W2s[:, :h2])
                   + ein("cmk,mp->cpk", Him, W2c[:, :h2]))
            spec_re = Ore.reshape(-1, h2 * N1)[:, :half]
            spec_im = Oim.reshape(-1, h2 * N1)[:, :half]
            magn = 2.0 * jnp.sqrt(spec_re ** 2 + spec_im ** 2)
            phase = jnp.arctan2(spec_im, spec_re)
            # phase-difference → true frequency (smb analysis).  The C wraps
            # with the qpd idiom (truncate-and-evenize, saf_utility_pitch.c
            # ~283-287), which differs from round() only at exact odd
            # multiples of π — reachable in f32 at the DC bin — so mirror it.
            tmp = phase - last_ph - k * expct
            qpd = (tmp / jnp.pi).astype(jnp.int32)
            qpd = qpd + jnp.where(qpd >= 0, qpd & 1, -(qpd & 1))
            tmp = tmp - jnp.pi * qpd.astype(tmp.dtype)
            true_freq = k * freq_per_bin + (osamp * tmp / (2 * jnp.pi)) * freq_per_bin
            # reassign bins: index = (int)(k * shift); the C SKIPS invalid
            # indices (no write, saf_utility_pitch.c:310-316) and its
            # gSynFreq assignment is last-k-wins on duplicates.  idx is
            # monotone in k, so keeping only the last k of each run makes
            # the scatter duplicate-free (deterministic); invalid ks are
            # routed out of bounds and dropped.
            idx = jnp.floor(k * shift_factor).astype(jnp.int32)
            idx_f = jnp.where(idx <= (N // 2), idx, half)  # oob sentinel
            syn_mag = jnp.zeros_like(magn).at[:, idx_f].add(
                magn, mode="drop")
            last_of_run = jnp.concatenate(
                [idx_f[:-1] != idx_f[1:], jnp.ones((1,), bool)])
            idx_set = jnp.where(last_of_run, idx_f, half)
            syn_freq = jnp.zeros_like(true_freq).at[:, idx_set].set(
                true_freq * shift_factor, mode="drop")
            # synthesis phases
            tmp2 = ((syn_freq - k * freq_per_bin) / freq_per_bin
                    ) * 2.0 * jnp.pi / osamp + k * expct
            sum_ph = sum_ph + tmp2
            # The C synthesis (saf_utility_pitch.c:352-357) zeroes the
            # negative-frequency bins WITHOUT conjugate symmetrisation and
            # takes the real part of the unscaled complex inverse:
            #   U(n) = Re Σ_{k=0}^{N/2} S_k e^{+i2πkn/N}
            # computed directly by the inverse Cooley-Tukey stages; the
            # accumulation is 2·win·U/(N·osamp) (kissFFT backward is 1/N).
            re = syn_mag * jnp.cos(sum_ph)
            im = syn_mag * jnp.sin(sum_ph)
            nch = re.shape[0]
            # rows k2 > N2/2 of the [k2, k1] layout are all-zero (bins above
            # N/2): keep only the populated h2 rows through the inverse stage
            h2 = N2 // 2 + 1
            re_f = jnp.zeros((nch, h2 * N1), re.dtype).at[:, :half].set(re)
            im_f = jnp.zeros((nch, h2 * N1), im.dtype).at[:, :half].set(im)
            Sre = re_f.reshape(nch, h2, N1)   # [k2, k1]
            Sim = im_f.reshape(nch, h2, N1)
            Pre = (ein("cpk,pm->cmk", Sre, W2ic[:h2])
                   - ein("cpk,pm->cmk", Sim, W2is[:h2]))
            Pim = (ein("cpk,pm->cmk", Sre, W2is[:h2])
                   + ein("cpk,pm->cmk", Sim, W2ic[:h2]))
            Qre = Pre * Tic - Pim * Tis
            Qim = Pre * Tis + Pim * Tic
            Ure = (ein("cmk,kq->cmq", Qre, W1ic)
                   - ein("cmk,kq->cmq", Qim, W1is))   # [m2, m1]
            U = jnp.swapaxes(Ure, -1, -2).reshape(nch, N)  # n = m2 + N2·m1
            accum = accum + 2.0 * win * U / (N * osamp)
            out_fifo = accum[:, :step]
            accum = jnp.concatenate(
                [accum[:, step:], jnp.zeros((x.shape[0], step), accum.dtype)], -1)
            return (buf[:, step:], accum, phase, sum_ph, out_fifo), out_hop

        hops = jnp.moveaxis(x.reshape(x.shape[0], n_frames, step), 1, 0)
        carry = (state.in_fifo, state.out_accum, state.last_phase,
                 state.sum_phase, state.out_fifo)
        carry, outs = jax.lax.scan(frame_step, carry, hops)
        y = jnp.moveaxis(outs, 0, 1).reshape(x.shape[0], -1)
        return y, SmbPitchShiftState(*carry)
