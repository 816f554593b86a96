"""sldoa — spatially-localised active-intensity DoA analyser (counterpart of
``examples/src/sldoa``; McCormack et al. 2019, JAES 67(11)).

Full reference machinery:

* **Per-order sector design** (sldoa_internal.c:62-122): for every analysis
  order o in 2..masterOrder, o² sector directions come from the minimal
  sphere-covering presets; VBAP gain patterns over a dense icosphere fit
  grid (the reference's precomputed 2562-point ``sldoa_database.c`` grid is
  regenerated here from our geosphere + SH basis) are multiplied with the
  omni + normalised-dipole basis rows and least-squares-fitted (pinv of the
  grid SH matrix) to give each sector's WXYZ beamforming coefficients.
* **Per-band analysis order** (sldoa_internal.h:124): each band analyses at
  MIN(analysisOrderPerBand[band], masterOrder); order-1 bands use WXYZ
  directly.  All bands' coefficients are baked into ONE (nBands, maxSec, 4,
  nSH) tensor at design time so the whole frame is a single einsum.
* **Estimation** (sldoa_internal.c:144-209): sector signals → N3D→SN3D
  dipole scaling → energy + active intensity → per-slot azi/elev.
* **Averaging + display** (sldoa.c:263-336): DoAs one-pole-averaged in
  Cartesian sequentially across time slots, energies one-pole-averaged;
  per-band azi/elev/colour/alpha display vectors with [minFreq, maxFreq]
  gating and per-band energy normalisation.

Split real/imaginary front-end (ops.afstft_ri) + real einsums —
no complex64 anywhere, the sector coefficients are real by construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.modules import sh, vbap
from spatial_audio_framework_tpu.ops import afstft_ri as ri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT
from spatial_audio_framework_tpu.utils import presets
from spatial_audio_framework_tpu.ops import precision as _prec


def order2num_sectors(order: int) -> int:
    """ORDER2NUMSECTORS(order) = order² (sldoa_internal.h)."""
    return max(1, order * order)


@dataclass(frozen=True)
class SldoaConfig:
    master_order: int = 1
    fs: float = 48000.0
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    hop: int = 128
    # Per-band analysis order, clipped to [1, master_order]; None → master
    # everywhere (sldoa.c:62).  Static (shape-determining).
    analysis_order_per_band: Optional[Tuple[int, ...]] = None
    min_freq: float = 500.0   # sldoa.c:65
    max_freq: float = 5e3     # sldoa.c:66
    avg_ms: float = 500.0     # sldoa.c:67
    fit_grid_level: int = 16  # icosphere freq → 2562 dirs (sldoa_database.h)

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

    @property
    def max_sectors(self) -> int:
        return order2num_sectors(self.master_order)

    @property
    def afstft(self) -> AfSTFT:
        return AfSTFT(hop=self.hop, hybrid=True)

    def orders_per_band(self) -> np.ndarray:
        n_bands = self.afstft.n_bands
        if self.analysis_order_per_band is None:
            return np.full(n_bands, self.master_order, int)
        o = np.asarray(self.analysis_order_per_band, int)
        assert o.shape == (n_bands,), (o.shape, n_bands)
        return np.clip(o, 1, self.master_order)

    @property
    def avg_coeff(self) -> float:
        """sldoa.c:271-272 one-pole coefficient from avg_ms."""
        if self.avg_ms < 10.0:
            return 0.99999
        a = 1.0 / ((self.avg_ms / 1e3) / (1.0 / self.hop) + 2.23e-9)
        return float(np.clip(a, 0.0, 0.99999))

    def __post_init__(self):
        C.validate_config(self)


def _sector_coeffs_vbap(order: int, nsh_master: int,
                        grid_dirs_deg: np.ndarray, Y_grid: np.ndarray,
                        dipoles_norm: np.ndarray) -> tuple:
    """One order's sector coefficients (sldoa_internal.c:73-117):
    VBAP-interp gains of the sphere-covering sector layout over the fit
    grid, imposed on [omni, normalised dipoles], LS-fitted via pinv(Y)."""
    n_sec = order2num_sectors(order)
    nsh_o = (order + 1) ** 2
    sec_dirs = presets.sphere_covering(n_sec)
    g = vbap.generate_vbap_gain_table_3d_srcs(grid_dirs_deg, sec_dirs)
    g = vbap.vbap_gain_table_to_interp_table(g)          # (nGrid, nSec)
    basis = np.concatenate([Y_grid[0:1], dipoles_norm], 0)  # (4, nGrid)
    pinv_Y = np.linalg.pinv(Y_grid[:nsh_o])              # (nGrid, nSH_o)
    # secPatterns[n] = vbap_col_n * basis → w = patterns @ pinv_Y
    pat = g.T[:, None, :] * basis[None, :, :]            # (nSec, 4, nGrid)
    w = pat @ pinv_Y                                     # (nSec, 4, nSH_o)
    out = np.zeros((n_sec, 4, nsh_master), np.float32)
    out[:, :, :nsh_o] = w
    return out, sec_dirs


class SldoaWeights(NamedTuple):
    sec_coeffs: jax.Array   # (nBands, maxSec, 4, nSH) per-band WXYZ beams
    sec_mask: jax.Array     # (nBands, maxSec) valid-sector mask
    band_in_range: jax.Array  # (nBands,) [minFreq, maxFreq] gate, DC off
    colour_scale: jax.Array   # (nBands,) static display colours
    conv_in: jax.Array
    sec_dirs_deg: dict      # order → (nSec, 2) sector directions
    orders_per_band: np.ndarray
    # static per-ORDER band groups: (band_mask (nB,), coeffs (maxSec·4,
    # nSH)) per distinct analysis order.  All bands in a group share one
    # coefficient matrix, so the sector-signal contraction is ONE
    # (maxSec·4, nSH) @ (nSH, nB·H) matmul per group instead of nB
    # tiny (36×16)@(16×H) batched matmuls
    order_groups: tuple


def design(cfg: SldoaConfig) -> SldoaWeights:
    conv = C.input_conversion_mtx(cfg.master_order, cfg.ch_ordering, cfg.norm)
    orders = cfg.orders_per_band()
    n_bands = cfg.afstft.n_bands
    max_sec = cfg.max_sectors

    # fit grid (regenerates the sldoa_database tables)
    grid = presets.geosphere(cfg.fit_grid_level)         # (~2562, 2) deg
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y_grid = sh.get_sh_real(cfg.master_order, dirs_rad) * np.sqrt(4 * np.pi)
    dipoles_norm = Y_grid[1:4] / np.sqrt(3.0)            # sldoa.c:88

    # per-order coefficient tables (orders ≥ 2)
    per_order, sec_dirs_deg = {}, {}
    for o in sorted(set(orders[orders >= 2].tolist())):
        per_order[o], sec_dirs_deg[o] = _sector_coeffs_vbap(
            o, cfg.nsh, grid, Y_grid, dipoles_norm)
    # order-1 "sector": WXYZ passthrough, ACN rows (W, Y, Z, X) reordered to
    # the estimator's (W, X', Y', Z') slots as in the first-order branch
    o1 = np.zeros((1, 4, cfg.nsh), np.float32)
    o1[0, :4, :4] = np.eye(4)
    sec_dirs_deg[1] = np.zeros((1, 2))

    coeffs = np.zeros((n_bands, max_sec, 4, cfg.nsh), np.float32)
    mask = np.zeros((n_bands, max_sec), np.float32)
    for b, o in enumerate(orders):
        cb = per_order[o] if o >= 2 else o1
        coeffs[b, :cb.shape[0]] = cb
        mask[b, :cb.shape[0]] = 1.0

    groups = []
    for o in sorted(set(orders.tolist())):
        cb = per_order[o] if o >= 2 else o1
        cfull = np.zeros((max_sec * 4, cfg.nsh), np.float32)
        cfull[:cb.shape[0] * 4] = cb.reshape(-1, cfg.nsh)
        groups.append((jnp.asarray((orders == o).astype(np.float32)),
                       jnp.asarray(cfull)))

    freqs = cfg.afstft.centre_freqs(cfg.fs)
    in_range = ((freqs >= cfg.min_freq) & (freqs <= cfg.max_freq))
    in_range[0] = False  # ignore DC (sldoa.c:266)
    min_band = int(np.max(np.nonzero(freqs <= cfg.min_freq)[0], initial=0))
    n_ana = max(int(in_range.sum()), 1)
    colour = np.where(in_range,
                      (np.arange(n_bands) - min_band) / (n_ana + 1.0),
                      0.0).astype(np.float32)

    return SldoaWeights(
        sec_coeffs=jnp.asarray(coeffs), sec_mask=jnp.asarray(mask),
        band_in_range=jnp.asarray(in_range.astype(np.float32)),
        colour_scale=jnp.asarray(colour), conv_in=jnp.asarray(conv),
        sec_dirs_deg=sec_dirs_deg, orders_per_band=orders,
        order_groups=tuple(groups))


class SldoaState(NamedTuple):
    bank: ri.AfSTFTStateRI
    doa_xyz: jax.Array   # (nBands, maxSec, 3) averaged DoA unit vectors
    energy: jax.Array    # (nBands, maxSec) averaged sector energies


class SldoaOutput(NamedTuple):
    doa_rad: jax.Array       # (nBands, maxSec, H, 2) raw per-slot estimates
    energy: jax.Array        # (nBands, maxSec, H) raw per-slot energies ×1e6
    azi_deg: jax.Array       # (nBands, maxSec) averaged display azimuths
    elev_deg: jax.Array      # (nBands, maxSec)
    colour_scale: jax.Array  # (nBands, maxSec)
    alpha_scale: jax.Array   # (nBands, maxSec)


def init_state(cfg: SldoaConfig) -> SldoaState:
    n_bands = cfg.afstft.n_bands
    init_xyz = jnp.zeros((n_bands, cfg.max_sectors, 3), jnp.float32)
    init_xyz = init_xyz.at[..., 0].set(1.0)  # arbitrary unit vectors
    return SldoaState(bank=ri.init_state_ri(cfg.afstft, cfg.nsh, 1),
                      doa_xyz=init_xyz,
                      energy=jnp.zeros((n_bands, cfg.max_sectors),
                                       jnp.float32))


def analysis(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
             x: jax.Array):
    """x: (nSH, T) → (SldoaOutput, state).  Fully jittable, complex-free."""
    xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri(cfg.afstft, state.bank, xc)
    out, doa_xyz, energy = _post_front(cfg, w, state, sre, sim)
    return out, SldoaState(bank=bank_st, doa_xyz=doa_xyz, energy=energy)


def init_state_batched(cfg: SldoaConfig, n: int) -> SldoaState:
    """State for ``analysis_batched``: n independent analyser instances
    (batched afSTFT front state; see powermap.init_state_batched)."""
    n_bands = cfg.afstft.n_bands
    init_xyz = jnp.zeros((n, n_bands, cfg.max_sectors, 3), jnp.float32)
    init_xyz = init_xyz.at[..., 0].set(1.0)
    return SldoaState(bank=ri.init_state_batched(cfg.afstft, n, cfg.nsh, 1),
                      doa_xyz=init_xyz,
                      energy=jnp.zeros((n, n_bands, cfg.max_sectors),
                                       jnp.float32))


def analysis_batched(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
                     x: jax.Array):
    """n independent sldoa instances in ONE dispatch: x (n, nSH, T) →
    (SldoaOutput with a leading n axis, state).  The afSTFT front-end runs
    as ONE batched analysis over all n·nSH channels; the estimator is
    per-instance vmapped.  Same rationale as powermap.analysis_batched."""
    xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri_batched(cfg.afstft, state.bank, xc)
    sre = sre.transpose(0, 3, 1, 2)    # (n, nB, nSH, H)
    sim = sim.transpose(0, 3, 1, 2)
    out, doa_xyz, energy = jax.vmap(
        lambda st, a, b: _post_front(cfg, w, st, a, b))(state, sre, sim)
    return out, SldoaState(bank=bank_st, doa_xyz=doa_xyz, energy=energy)


def _post_front(cfg: SldoaConfig, w: SldoaWeights, state: SldoaState,
                sre: jax.Array, sim: jax.Array):
    """Sector estimation + slot averaging from (nB, nSH, H) spectra;
    shared by the single-instance and batched entry points."""
    hp = _prec.HOT
    # layout: every H-scale tensor below is (…, nB·H), with no trailing
    # 3-wide (xyz) or 4-wide (WXYZ) axis on a big tensor (a narrow minor
    # axis pads badly in tiled device layouts)
    nB, nsh, H = sre.shape
    S_ = w.sec_mask.shape[1]
    BH = nB * H
    st_re = sre.transpose(1, 0, 2).reshape(nsh, BH)
    st_im = sim.transpose(1, 0, 2).reshape(nsh, BH)
    # sector WXYZ signals (RI): one lane-wide matmul per static order
    # group (see SldoaWeights.order_groups) — contraction identical to
    # einsum("bcws,bsh->bcwh", sec_coeffs, s*)
    ws_re = jnp.zeros((S_ * 4, BH), jnp.float32)
    ws_im = jnp.zeros((S_ * 4, BH), jnp.float32)
    for gm, coef in w.order_groups:
        mb = jnp.broadcast_to(gm[:, None], (nB, H)).reshape(1, BH)
        ws_re = ws_re + mb * jnp.matmul(coef, st_re, precision=hp)
        ws_im = ws_im + mb * jnp.matmul(coef, st_im, precision=hp)
    # N3D→SN3D on the dipoles (sldoa_internal.c:182-185)
    scale = jnp.asarray([1.0] + [1.0 / np.sqrt(3.0)] * 3, jnp.float32)
    ws_re = ws_re.reshape(S_, 4, BH) * scale[None, :, None]
    ws_im = ws_im.reshape(S_, 4, BH) * scale[None, :, None]
    energy_s = 0.5 * jnp.sum(ws_re ** 2 + ws_im ** 2, axis=1)   # (S, BH)
    # active intensity: Re(conj(W) · dipole); dipole slots are the ACN
    # rows (Y, Z, X) so azi = atan2(I_y, I_x), elev vs the horizontal
    # plane (sldoa_internal.c:196-199)
    Iy = ws_re[:, 0] * ws_re[:, 1] + ws_im[:, 0] * ws_im[:, 1]  # (S, BH)
    Iz = ws_re[:, 0] * ws_re[:, 2] + ws_im[:, 0] * ws_im[:, 2]
    Ix = ws_re[:, 0] * ws_re[:, 3] + ws_im[:, 0] * ws_im[:, 3]

    def to_bsh(t):   # (S, B·H) → (B, S, H)
        return t.reshape(S_, nB, H).transpose(1, 0, 2)

    azi = jnp.arctan2(Iy, Ix)
    elev = jnp.arctan2(Iz, jnp.sqrt(Ix * Ix + Iy * Iy))
    doa = jnp.stack([to_bsh(azi), to_bsh(elev)], axis=-1)    # (B, S, H, 2)
    energy = to_bsh(energy_s)                                # (B, S, H)

    # one-pole averaging across slots (sldoa.c:279-292)
    a = cfg.avg_coeff
    # per-slot DoA unit vector: the C's cos/sin(atan2(..)) round trip is
    # algebraically I/‖I‖, so skip the five transcendental maps; the
    # all-zero intensity case maps to (1, 0, 0) exactly as cos(0)cos(0)
    n2 = Ix * Ix + Iy * Iy + Iz * Iz
    nz = n2 > 0
    # no lower clamp: rsqrt of even the smallest positive f32 (~1.4e-45)
    # stays finite (~8.4e22), and a clamp would return a near-zero,
    # non-unit vector for subnormal intensities (a quiet fade-out) where
    # the C's atan2/cos/sin still yields a unit vector; the n2 == 0 lane
    # is masked by ``nz`` below, so the inf in its dead branch is unused
    inv = jnp.where(nz, jax.lax.rsqrt(n2), 0.0)
    ux = jnp.where(nz, Ix * inv, 1.0)                        # (S, BH) each
    uy = jnp.where(nz, Iy * inv, 0.0)
    uz = jnp.where(nz, Iz * inv, 0.0)
    gate = (w.band_in_range[:, None] * w.sec_mask)[..., None]  # (B, S, 1)
    gate_t = (w.sec_mask * w.band_in_range[:, None]).transpose(1, 0) > 0

    # energy: the gated one-pole is LINEAR, so fold all H slots in closed
    # form — one weighted reduction instead of H sequential steps
    wgt = a * (1.0 - a) ** jnp.arange(H - 1, -1, -1.0, dtype=jnp.float32)
    en_fold = (state.energy.transpose(1, 0) * (1.0 - a) ** H
               + jnp.einsum("sbh,h->sb", 1e6 * energy_s.reshape(S_, nB, H),
                            wgt, precision=hp))
    avg_en = jnp.where(gate_t, en_fold,
                       state.energy.transpose(1, 0)).transpose(1, 0)

    # DoA: per-slot renormalisation makes the fold nonlinear — keep the
    # sequential scan; carry the three (S, nB) component planes
    def slot_step(carry, slot):
        x, y, z = carry
        xn, yn, zn = slot
        px = xn * a + x * (1.0 - a)
        py = yn * a + y * (1.0 - a)
        pz = zn * a + z * (1.0 - a)
        nrm = jnp.maximum(jnp.sqrt(px * px + py * py + pz * pz), 1e-12)
        x = jnp.where(gate_t, px / nrm, x)
        y = jnp.where(gate_t, py / nrm, y)
        z = jnp.where(gate_t, pz / nrm, z)
        return (x, y, z), None

    def slots(t):    # (S, B·H) → (H, S, B) scan steps
        return t.reshape(S_, nB, H).transpose(2, 0, 1)

    carry0 = tuple(state.doa_xyz[..., j].transpose(1, 0) for j in range(3))
    (cx, cy, cz), _ = jax.lax.scan(slot_step, carry0,
                                   (slots(ux), slots(uy), slots(uz)))
    avg_xyz = jnp.stack([cx, cy, cz], axis=-1).transpose(1, 0, 2)

    # display vectors (sldoa.c:297-336)
    azi_avg = jnp.degrees(jnp.arctan2(avg_xyz[..., 1], avg_xyz[..., 0]))
    elev_avg = jnp.degrees(jnp.arctan2(
        avg_xyz[..., 2], jnp.sqrt(avg_xyz[..., 0] ** 2 + avg_xyz[..., 1] ** 2)))
    g2 = gate[..., 0]
    big = jnp.float32(2.3e13)
    en_valid = jnp.where(w.sec_mask > 0, avg_en, -big)
    max_en = en_valid.max(axis=1, keepdims=True)
    en_valid_min = jnp.where(w.sec_mask > 0, avg_en, big)
    min_en = en_valid_min.min(axis=1, keepdims=True)
    alpha = jnp.clip((avg_en - min_en) / (max_en - min_en + 2.3e-10),
                     0.05, 1.0)
    first_order = (jnp.asarray((w.orders_per_band == 1)
                               .astype(np.float32))[:, None])
    alpha = jnp.where(first_order > 0, 1.0, alpha)
    out = SldoaOutput(
        doa_rad=doa, energy=energy * 1e6,
        azi_deg=azi_avg * g2, elev_deg=elev_avg * g2,
        colour_scale=w.colour_scale[:, None] * w.sec_mask,
        alpha_scale=alpha * g2)
    return out, avg_xyz, avg_en
