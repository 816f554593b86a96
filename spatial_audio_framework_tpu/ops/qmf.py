"""Complex hybrid QMF filterbank (counterpart of ``saf_utility_qmf``).

Complex-modulated K-band filterbank with a 10·hop prototype, plus an optional
hybrid stage that subdivides the 3 lowest bands (8/4/4 subbands → K+7 hybrid
bands; saf_utility_qmf.c:149-313,314-436,437-560).

The structure mirrors ops.afstft: pure block-batched functions with an
explicit state pytree; the per-hop modulation is a dense (2·hop × K) complex
matmul and the hybrid stage a 13-tap FIR along hop-time.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

QMF_MAX_HOP = 128
HYB_LEN = 13       # QMF_HYBRID_FILTER_LENGTH
N_SUBDIV = 3       # QMF_NBANDS_2_SUBDIVIDE
_HYB_DELAY = (HYB_LEN - 1) // 2  # 6 hops


@functools.lru_cache(maxsize=None)
def _tables():
    import importlib.resources as res

    path = res.files("spatial_audio_framework_tpu").joinpath("data/qmf_proto.npz")
    with path.open("rb") as f:
        z = np.load(f)
        return {k: z[k].copy() for k in z.keys()}


@functools.lru_cache(maxsize=None)
def _design(hop: int):
    """Prototype window, analysis/synthesis modulators, hybrid FIRs."""
    t = _tables()
    K, N = hop, 2 * hop
    if hop <= QMF_MAX_HOP:
        h_p = t["proto"][:: QMF_MAX_HOP // hop][: 10 * hop]
    else:
        from spatial_audio_framework_tpu.ops.afstft import _load_proto, _EQ_NORMAL

        ds = 1024 // hop
        h_p = _load_proto()["normal"][::ds] * _EQ_NORMAL
    k = np.pi / 2.0 / K * (np.arange(K) + 0.5)
    n_a = 2.0 * np.arange(N) - 2.0 * K / QMF_MAX_HOP
    H_a = (QMF_MAX_HOP / (2.0 * hop)) * np.exp(1j * np.outer(k, n_a))  # (K, N)
    n_s = 2.0 * np.arange(N) - (2.0 * QMF_MAX_HOP - 1.0) * K / (QMF_MAX_HOP / 2.0)
    Hs = (2.0 / QMF_MAX_HOP) * np.exp(1j * np.outer(n_s, k))  # (N, K)
    # hybrid FIRs (saf_utility_qmf.c:236-253)
    j = np.arange(HYB_LEN)
    fb8 = (t["fb8"][None, :]
           * np.exp(-1j * np.pi * (j - (HYB_LEN - 1) / 2.0)[None, :] / 8.0
                    * (1.0 + 2.0 * np.arange(8))[:, None]))  # (8, 13)
    fb4 = (t["fb4"][None, :]
           * np.cos(2.0 * np.pi * np.arange(2)[:, None]
                    * (j - (HYB_LEN - 1) / 2.0)[None, :] / 2.0))  # (2, 13)
    return {"h_p": h_p.astype(np.float32),
            "H_a": H_a.astype(np.complex64),
            "Hs_re": Hs.real.astype(np.float32),
            "Hs_im": Hs.imag.astype(np.float32),
            "fb8": fb8.astype(np.complex64), "fb4": fb4.astype(np.complex64)}


class QMFState(NamedTuple):
    in_tail: jax.Array    # (n_ch, 9*hop) most-recent input samples
    hyb_tail: jax.Array   # (n_ch, 12, 3) past low-band frames
    delay_tail: jax.Array  # (n_ch, 6, K-3) past high-band frames
    syn_tail: jax.Array   # (n_ch, 9, 2*hop) past synthesis frames


@dataclass(frozen=True)
class QMF:
    hop: int = 128
    hybrid: bool = True

    @property
    def n_bands(self) -> int:
        return self.hop + (7 if self.hybrid else 0)

    @property
    def proc_delay(self) -> int:
        """saf_utility_qmf.c:259-263."""
        return self.hop * 15 + 1 if self.hybrid else self.hop * 9 + 1

    def centre_freqs(self, fs: float) -> np.ndarray:
        """saf_utility_qmf.c ``qmf_getCentreFreqs``: uniform K bands at
        (k+0.5)·fs/(2K); hybrid maps the first 3 via __qmf2hybCentreFreq."""
        K = self.hop
        uni = (np.arange(K) + 0.5) * fs / (2.0 * K)
        if not self.hybrid:
            return uni.astype(np.float32)
        scale = np.array([0.1013, 0.2027, 0.4054, 0.8108, 1.2533, 1.7227,
                          0.9039, 1.1228, 0.9424, 1.0672])
        src = np.array([0, 0, 0, 0, 0, 0, 1, 1, 2, 2])
        return np.concatenate([scale * uni[src], uni[3:]]).astype(np.float32)

    def init_state(self, n_ch_in: int, n_ch_out: int) -> QMFState:
        hop = self.hop
        return QMFState(
            in_tail=jnp.zeros((n_ch_in, 9 * hop), jnp.float32),
            hyb_tail=jnp.zeros((n_ch_in, HYB_LEN - 1, N_SUBDIV), jnp.complex64),
            delay_tail=jnp.zeros((n_ch_in, _HYB_DELAY, hop - N_SUBDIV), jnp.complex64),
            syn_tail=jnp.zeros((n_ch_out, 9, 2 * hop), jnp.float32),
        )

    # -- analysis ------------------------------------------------------------
    def analysis(self, state: QMFState, x: jax.Array):
        """x: (n_ch, H*hop) → ((n_bands, n_ch, H) complex, state)."""
        hop = self.hop
        dz = _design(hop)
        n_ch = x.shape[0]
        H = x.shape[1] // hop
        buf = jnp.concatenate([state.in_tail, x], axis=-1)
        hops = buf.reshape(n_ch, H + 9, hop)
        seg = jnp.stack([hops[:, k: k + H] for k in range(10)], axis=2)
        seg = seg.reshape(n_ch, H, 10 * hop)
        # reversed buffer ordering (qmf_analysis copies the hop with stride -1)
        seg_rev = seg[..., ::-1]
        win = seg_rev * jnp.asarray(dz["h_p"])
        ws = win.reshape(n_ch, H, 5, 2 * hop).sum(axis=2)  # (n_ch, H, 2*hop)
        B = jnp.einsum("kn,chn->chk", jnp.asarray(dz["H_a"]),
                       ws.astype(jnp.complex64))  # (n_ch, H, K)
        new_in_tail = buf[:, H * hop:]
        if not self.hybrid:
            return B.transpose(2, 0, 1), state._replace(in_tail=new_in_tail)

        low = B[..., :N_SUBDIV]  # (n_ch, H, 3)
        full = jnp.concatenate([state.hyb_tail, low], axis=1)  # (n_ch, 12+H, 3)
        # 13-tap FIR along hop-time: out[t] = Σ_j c[j]·full[t+j]
        win13 = jnp.stack([full[:, j: j + H] for j in range(HYB_LEN)], axis=2)
        s8 = jnp.einsum("ij,chjs->chis", jnp.asarray(dz["fb8"]),
                        win13)[..., 0]  # (n_ch, H, 8) from band 0
        s4b = jnp.einsum("ij,chj->chi", jnp.asarray(dz["fb4"]), win13[..., 1])
        s4c = jnp.einsum("ij,chj->chi", jnp.asarray(dz["fb4"]), win13[..., 2])
        hyb_low = jnp.stack([
            s8[..., 6], s8[..., 7], s8[..., 0], s8[..., 1],
            s8[..., 2] + s8[..., 5], s8[..., 3] + s8[..., 4],
            s4b[..., 1], s4b[..., 0],          # "Flipped!" (qmf_analysis)
            s4c[..., 0], s4c[..., 1]], axis=-1)  # (n_ch, H, 10)
        # remaining bands delayed by 6 hops
        rest = B[..., N_SUBDIV:]
        full_rest = jnp.concatenate([state.delay_tail, rest], axis=1)
        rest_del = full_rest[:, :H]
        out = jnp.concatenate([hyb_low, rest_del], axis=-1)  # (n_ch, H, K+7)
        return out.transpose(2, 0, 1), state._replace(
            in_tail=new_in_tail, hyb_tail=full[:, H: H + HYB_LEN - 1],
            delay_tail=full_rest[:, H: H + _HYB_DELAY])

    # -- synthesis -----------------------------------------------------------
    def synthesis(self, state: QMFState, Y: jax.Array):
        """Y: (n_bands, n_ch, H) complex → ((n_ch, H*hop), state)."""
        hop = self.hop
        dz = _design(hop)
        Y = Y.transpose(1, 2, 0)  # (n_ch, H, n_bands)
        n_ch, H = Y.shape[:2]
        if self.hybrid:
            low = jnp.stack([Y[..., 0:6].sum(-1), Y[..., 6] + Y[..., 7],
                             Y[..., 8] + Y[..., 9]], axis=-1)
            Y = jnp.concatenate([low, Y[..., 10:]], axis=-1)  # (n_ch, H, K)
        v = (jnp.real(Y) @ jnp.asarray(dz["Hs_re"]).T
             - jnp.imag(Y) @ jnp.asarray(dz["Hs_im"]).T)  # (n_ch, H, 2*hop)
        full = jnp.concatenate([state.syn_tail, v], axis=1)  # (n_ch, 9+H, 2*hop)
        # out_t[i] = Σ_m h_p[m·hop+i] · v_{t-m}[(m%2)·hop + i]
        hp = dz["h_p"].reshape(10, hop)
        pieces = []
        for m in range(10):
            sl = full[:, 9 - m: 9 - m + H, (m % 2) * hop:(m % 2) * hop + hop]
            pieces.append(sl * jnp.asarray(hp[m]))
        out = sum(pieces)  # (n_ch, H, hop)
        return (out.reshape(n_ch, H * hop),
                state._replace(syn_tail=full[:, H: H + 9]))


def qmf_fir_to_filterbank_coeffs(h_ir: np.ndarray, hop: int,
                                 hybrid: bool = True) -> np.ndarray:
    """FIR → QMF-domain coefficients (saf_utility_qmf.c
    ``qmf_FIRtoFilterbankCoeffs``); same energy/phase fit as the afSTFT
    variant.  h_ir: (n_dirs, n_ch, len) → (n_bands, n_ch, n_dirs)."""
    cfg = QMF(hop=hop, hybrid=hybrid)
    n_dirs, n_ch, ir_len = h_ir.shape
    T = max(ir_len, hop) + 1024

    def analyse(sig):
        n = sig.shape[0]
        n_slots = -(-sig.shape[1] // hop)
        buf = np.zeros((n, n_slots * hop), np.float32)
        buf[:, : sig.shape[1]] = sig
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            st = cfg.init_state(n, 1)
            out, _ = jax.jit(cfg.analysis)(st, jnp.asarray(buf))
            return np.asarray(out)

    idx_del = int(np.mean(np.argmax(h_ir[0], axis=-1)) + 1.5)
    center = np.zeros((1, T), np.float32)
    center[0, idx_del] = 1.0
    D = analyse(center)[:, 0]
    d_energy = np.maximum((np.abs(D) ** 2).sum(-1), 2.23e-8)
    sig = np.zeros((n_dirs * n_ch, T), np.float32)
    sig[:, :ir_len] = h_ir.reshape(n_dirs * n_ch, ir_len)
    X = analyse(sig)
    gain = np.sqrt((np.abs(X) ** 2).sum(-1) / d_energy[:, None])
    cross = np.einsum("bct,bt->bc", X, D.conj())
    g = gain * np.exp(1j * np.angle(cross))
    return (g.reshape(-1, n_dirs, n_ch).transpose(0, 2, 1)).astype(np.complex64)
