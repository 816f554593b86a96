"""powermap — SH-domain activity-map analyser (counterpart of
``examples/src/powermap``).

Process: afSTFT analysis → per-band SCM with one-pole temporal averaging
(powermap.c:257-266) → order-truncated covariance grouping with per-band EQ
(powermap.c:275-289: each band contributes its top-left
(orderPerBand+1)²-block, scaled by 1e3·pmapEQ[band]) → activity map at the
max analysis order (PWD / MVDR / CroPaC-LCMV / MUSIC(±log) / MinNorm(±log))
→ map averaging on the analysis grid → VBAP interpolation to the dense
display grid (powermap.c:345-358).

The whole chain runs in split real/imaginary arithmetic (ops.afstft_ri
front-end + ops.herm_ri covariance algebra) — no complex64 ever reaches
the device graph.  Every mode including CroPaC is jittable; the per-band
analysis orders are static config (shape-determining, as in the reference
where changing them triggers a recalc), while the pmapEQ weights are traced
and can stream per call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spatial_audio_framework_tpu.models import _common as C
from spatial_audio_framework_tpu.modules import sh, sh_est, vbap
from spatial_audio_framework_tpu.ops import afstft_ri as ri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT
from spatial_audio_framework_tpu.utils import presets
from spatial_audio_framework_tpu.ops import precision as _prec

PM_PWD = "pwd"
PM_MVDR = "mvdr"
PM_CROPAC = "cropac_lcmv"
PM_MUSIC = "music"
PM_MUSIC_LOG = "music_log"
PM_MINNORM = "minnorm"
PM_MINNORM_LOG = "minnorm_log"


@dataclass(frozen=True)
class PowermapConfig:
    master_order: int = 1
    fs: float = 48000.0
    mode: str = PM_PWD
    n_sources: int = 1
    cov_avg_coeff: float = 0.5
    pmap_avg_coeff: float = 0.666       # powermap.c:51
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    # analysis grid: the reference scans the 812-dir icosahedral geosphere
    # (powermap_internal.c:57-59 geosphere_ico_freq = 9); a t-design can be
    # selected instead for cheaper maps
    analysis_grid: str = "geosphere_ico_9"
    grid_tdesign: int = 14              # used when analysis_grid == "tdesign"
    interp_res_deg: int = 5             # display grid resolution
    hop: int = 128
    # Per-band SH analysis order (len n_bands, each clipped to
    # [1, master_order]); None → master_order for every band
    # (powermap_internal.h:124 analysisOrderPerBand).  Static: changing it
    # re-designs/retraces, mirroring the reference's recalcPmap path.
    analysis_order_per_band: Optional[Tuple[int, ...]] = None

    @property
    def nsh(self) -> int:
        return (self.master_order + 1) ** 2

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
    def max_analysis_order(self) -> int:
        return int(self.orders_per_band().max())

    def __post_init__(self):
        C.validate_config(self)


class PowermapWeights(NamedTuple):
    Y_grid: jax.Array        # (nSH_max, nGrid) REAL SH steering
    interp_table: jax.Array  # (nInterp, nGrid)
    conv_in: jax.Array       # (nSH, nSH)
    band_mask: jax.Array     # (nBands, nSH_max) order-truncation masks
    grid_dirs_deg: np.ndarray
    interp_dirs_deg: np.ndarray


class PowermapState(NamedTuple):
    bank: ri.AfSTFTStateRI
    Cx_re: jax.Array      # (nBands, nSH, nSH)
    Cx_im: jax.Array
    prev_pmap: jax.Array  # (nGrid,) — averaged on the ANALYSIS grid
                          # before interpolation (powermap.c:345-347)


def design(cfg: PowermapConfig) -> PowermapWeights:
    if cfg.analysis_grid == "geosphere_ico_9":
        grid = presets.geosphere(9, icosahedral=True)
    else:
        grid = presets.tdesign(cfg.grid_tdesign)
    dirs_rad = np.stack([np.radians(grid[:, 0]),
                         np.pi / 2 - np.radians(grid[:, 1])], -1)
    max_order = cfg.max_analysis_order
    # the C scales the scanning-grid SH by 1/nSH (powermap_initAna,
    # powermap_internal.c:63 scaleY).  All maps except CroPaC are invariant
    # to this scale after the [0,1] display normalisation; CroPaC is NOT
    # (its MVDR base map scales as α⁻² while the LCMV cross-spectrum is
    # α-invariant, so the per-direction gain G mixes the two scalings).
    nsh_max = (max_order + 1) ** 2
    Y = sh.get_sh_real(max_order, dirs_rad) * np.sqrt(4.0 * np.pi) / nsh_max
    # display interpolation grid + amplitude-normalised VBAP table
    az = np.arange(-180, 180 + cfg.interp_res_deg, cfg.interp_res_deg)
    el = np.arange(-90, 90 + cfg.interp_res_deg, cfg.interp_res_deg)
    interp_dirs = np.stack(np.meshgrid(az, el), -1).reshape(-1, 2).astype(np.float64)
    g = vbap.generate_vbap_gain_table_3d_srcs(interp_dirs, grid)
    g = vbap.vbap_gain_table_to_interp_table(g)
    # order-truncation masks: band b contributes Cx rows/cols < (order_b+1)²
    orders = cfg.orders_per_band()
    mask = (np.arange(nsh_max)[None, :]
            < ((orders + 1) ** 2)[:, None]).astype(np.float32)
    return PowermapWeights(
        Y_grid=jnp.asarray(Y.astype(np.float32)),
        interp_table=jnp.asarray(g.astype(np.float32)),
        conv_in=jnp.asarray(C.input_conversion_mtx(cfg.master_order,
                                                   cfg.ch_ordering, cfg.norm)),
        band_mask=jnp.asarray(mask),
        grid_dirs_deg=grid, interp_dirs_deg=interp_dirs)


def init_state(cfg: PowermapConfig, w: PowermapWeights) -> PowermapState:
    n_bands = cfg.afstft.n_bands
    return PowermapState(
        bank=ri.init_state_ri(cfg.afstft, cfg.nsh, 1),
        Cx_re=jnp.zeros((n_bands, cfg.nsh, cfg.nsh), jnp.float32),
        Cx_im=jnp.zeros((n_bands, cfg.nsh, cfg.nsh), jnp.float32),
        prev_pmap=jnp.zeros(w.grid_dirs_deg.shape[0], jnp.float32))


def analysis(cfg: PowermapConfig, w: PowermapWeights, state: PowermapState,
             x: jax.Array, pmap_eq: Optional[jax.Array] = None):
    """x: (nSH, T) → (pmap (nInterp,) in [0,1], state).  Fully jittable in
    every mode; complex-free.  pmap_eq: optional per-band map EQ weights
    (nBands,), clipped to [0, 2] (powermap.c:284 pmapEQ)."""
    xc = w.conv_in @ x
    (sre, sim), bank_st = ri.analysis_ri(cfg.afstft, state.bank, xc)
    pmap_i, Cx_re, Cx_im, prev = _post_front(cfg, w, state, sre, sim,
                                             pmap_eq)
    return pmap_i, PowermapState(bank=bank_st, Cx_re=Cx_re, Cx_im=Cx_im,
                                 prev_pmap=prev)


def init_state_batched(cfg: PowermapConfig, w: PowermapWeights,
                       n: int) -> PowermapState:
    """State for ``analysis_batched``: n independent analyser instances.
    The filterbank state is the BATCHED afSTFT state (15-hop input tail,
    hybrid warm-up recomputed), so one batched analysis serves all
    instances."""
    n_bands = cfg.afstft.n_bands
    return PowermapState(
        bank=ri.init_state_batched(cfg.afstft, n, cfg.nsh, 1),
        Cx_re=jnp.zeros((n, n_bands, cfg.nsh, cfg.nsh), jnp.float32),
        Cx_im=jnp.zeros((n, n_bands, cfg.nsh, cfg.nsh), jnp.float32),
        prev_pmap=jnp.zeros((n, w.grid_dirs_deg.shape[0]), jnp.float32))


def analysis_batched(cfg: PowermapConfig, w: PowermapWeights,
                     state: PowermapState, x: jax.Array,
                     pmap_eq: Optional[jax.Array] = None):
    """n independent powermap instances in ONE dispatch.

    x: (n, nSH, T) → (pmaps (n, nInterp), state from init_state_batched).
    Unlike ``vmap(analysis)``, the afSTFT front-end runs as ONE batched
    analysis over all n·nSH channels (ops.afstft_ri.analysis_ri_batched,
    which never materialises the 10× frame stack); everything after the
    front is batch-tolerant over the leading instance axis.
    """
    xc = w.conv_in @ x                             # (n, nSH, T)
    (sre, sim), bank_st = ri.analysis_ri_batched(cfg.afstft, state.bank, xc)
    # batched front layout (n, nSH, H, nBands) → per-instance (nB, nSH, H)
    sre = sre.transpose(0, 3, 1, 2)
    sim = sim.transpose(0, 3, 1, 2)
    pmap_i, Cx_re, Cx_im, prev = _post_front(cfg, w, state, sre, sim,
                                             pmap_eq)
    return pmap_i, PowermapState(bank=bank_st, Cx_re=Cx_re, Cx_im=Cx_im,
                                 prev_pmap=prev)


def _scm_update(cfg: PowermapConfig, Cx_re, Cx_im, sre, sim):
    """One-pole SCM recursion from (..., nB, nSH, H) spectra (any leading
    batch dims): C = S Sᴴ in RI → re = Sre Sreᵀ + Sim Simᵀ,
    im = Sim Sreᵀ − Sre Simᵀ (powermap.c:257-266)."""
    H = sre.shape[-1]
    hp = _prec.HOT
    new_re = (jnp.einsum("...sh,...th->...st", sre, sre, precision=hp)
              + jnp.einsum("...sh,...th->...st", sim, sim, precision=hp)) / H
    new_im = (jnp.einsum("...sh,...th->...st", sim, sre, precision=hp)
              - jnp.einsum("...sh,...th->...st", sre, sim, precision=hp)) / H
    a = cfg.cov_avg_coeff
    return a * Cx_re + (1.0 - a) * new_re, a * Cx_im + (1.0 - a) * new_im


def _map_from_cov(cfg: PowermapConfig, w: PowermapWeights, Cx_re, Cx_im,
                  pmap_eq: Optional[jax.Array]):
    """Grouped covariance → activity map on the analysis grid, batched over
    any leading dims of Cx (..., nB, nSH, nSH) → (..., nGrid).  Batch-
    tolerance is what lets analysis_chunks run ONE eigh over all chunks ×
    instances instead of K sequential ones inside the scan."""
    hp = _prec.HOT
    # order-truncated grouping with per-band EQ (powermap.c:275-289)
    nsh_max = w.Y_grid.shape[0]
    if pmap_eq is None:
        eq = jnp.ones(cfg.afstft.n_bands, jnp.float32)
    else:
        eq = jnp.clip(pmap_eq, 0.0, 2.0)
    m = w.band_mask * (1e3 * eq)[:, None]          # (nBands, nSH_max)
    Ct_re = Cx_re[..., :nsh_max, :nsh_max]
    Ct_im = Cx_im[..., :nsh_max, :nsh_max]
    C_grp = (jnp.einsum("bi,bj,...bij->...ij", m, w.band_mask, Ct_re,
                        precision=hp),
             jnp.einsum("bi,bj,...bij->...ij", m, w.band_mask, Ct_im,
                        precision=hp))

    if cfg.mode == PM_PWD:
        pmap = sh_est.generate_pwd_map_ri(C_grp, w.Y_grid)
    elif cfg.mode == PM_MVDR:
        pmap = sh_est.generate_mvdr_map_ri(C_grp, w.Y_grid, 8.0)
    elif cfg.mode == PM_CROPAC:
        pmap = sh_est.generate_cropac_lcmv_map_ri(C_grp, w.Y_grid, 8.0, 0.0)
    elif cfg.mode in (PM_MUSIC, PM_MUSIC_LOG):
        pmap = sh_est.generate_music_map_ri(C_grp, w.Y_grid, cfg.n_sources,
                                            cfg.mode == PM_MUSIC_LOG)
    elif cfg.mode in (PM_MINNORM, PM_MINNORM_LOG):
        pmap = sh_est.generate_minnorm_map_ri(C_grp, w.Y_grid, cfg.n_sources,
                                              cfg.mode == PM_MINNORM_LOG)
    else:
        raise ValueError(cfg.mode)
    # trace guard: a silent scene yields a zero map (powermap.c:295-343)
    if cfg.mode != PM_PWD:
        tr = jnp.trace(C_grp[0], axis1=-2, axis2=-1)
        pmap = jnp.where((tr > 1e-8)[..., None], pmap,
                         jnp.zeros_like(pmap))
    return pmap


def _display(cfg: PowermapConfig, w: PowermapWeights, pmap, prev_pmap):
    """Map EWMA + VBAP display interpolation + [0,1] normalisation
    (powermap.c:345-365), batched over leading dims."""
    pmap = (1.0 - cfg.pmap_avg_coeff) * pmap \
        + cfg.pmap_avg_coeff * prev_pmap
    pmap_i = jnp.einsum("ig,...g->...i", w.interp_table,
                        pmap.astype(jnp.float32))
    pmin = pmap_i.min(axis=-1, keepdims=True)
    pmax = pmap_i.max(axis=-1, keepdims=True)
    return (pmap_i - pmin) / jnp.maximum(pmax - pmin, 1e-12), pmap


def _post_front(cfg: PowermapConfig, w: PowermapWeights,
                state: PowermapState, sre: jax.Array, sim: jax.Array,
                pmap_eq: Optional[jax.Array]):
    """SCM averaging → grouping → map → display interp, from (..., nB,
    nSH, H) spectra.  Shared by the single-instance and batched entry
    points (every piece is batched over leading dims)."""
    Cx_re, Cx_im = _scm_update(cfg, state.Cx_re, state.Cx_im, sre, sim)
    pmap = _map_from_cov(cfg, w, Cx_re, Cx_im, pmap_eq)
    pmap_i, prev = _display(cfg, w, pmap, state.prev_pmap)
    return pmap_i, Cx_re, Cx_im, prev


def analysis_chunks(cfg: PowermapConfig, w: PowermapWeights,
                    state: PowermapState, xs: jax.Array,
                    pmap_eq: Optional[jax.Array] = None):
    """K sequential chunks in one dispatch, with the map computation
    HOISTED out of the chunk recursion.

    xs: (K, nSH, T) — or (K, n, nSH, T) with a state from
    init_state_batched — → (pmaps (K[, n], nInterp), state).

    The SCM one-pole is the only true chunk-to-chunk dependency, so the
    scan carries just filterbank + Cx while stacking each chunk's
    smoothed covariance; the activity maps (including the MUSIC/MinNorm
    eigendecomposition — the dominant cost, ~2/3 of a MUSIC dispatch) then
    run ONCE batched over all K chunks (× n instances).  Numerically
    identical to K calls of ``analysis`` — the same eigh on the same
    matrices, just batched.  This is a restructuring with no C
    counterpart (powermap.c processes one hopsize per call); cite:
    /root/reference/examples/src/powermap/powermap.c:298-338.
    """
    batched = xs.ndim == 4

    def step(carry, xk):
        bank, Cre, Cim = carry
        xc = w.conv_in @ xk
        if batched:
            (sre, sim), bank = ri.analysis_ri_batched(cfg.afstft, bank, xc)
            sre = sre.transpose(0, 3, 1, 2)
            sim = sim.transpose(0, 3, 1, 2)
        else:
            (sre, sim), bank = ri.analysis_ri(cfg.afstft, bank, xc)
        Cre, Cim = _scm_update(cfg, Cre, Cim, sre, sim)
        return (bank, Cre, Cim), (Cre, Cim)

    (bank, Cre, Cim), (Cres, Cims) = jax.lax.scan(
        step, (state.bank, state.Cx_re, state.Cx_im), xs)
    pmaps = _map_from_cov(cfg, w, Cres, Cims, pmap_eq)  # ONE batched map

    def dstep(prev, pm):      # chunk-sequential display EWMA (tiny)
        nxt = (1.0 - cfg.pmap_avg_coeff) * pm + cfg.pmap_avg_coeff * prev
        return nxt, nxt

    prev, seq = jax.lax.scan(dstep, state.prev_pmap, pmaps)
    pmap_i = jnp.einsum("ig,...g->...i", w.interp_table,
                        seq.astype(jnp.float32))
    pmin = pmap_i.min(axis=-1, keepdims=True)
    pmax = pmap_i.max(axis=-1, keepdims=True)
    return ((pmap_i - pmin) / jnp.maximum(pmax - pmin, 1e-12),
            PowermapState(bank=bank, Cx_re=Cre, Cx_im=Cim, prev_pmap=prev))
