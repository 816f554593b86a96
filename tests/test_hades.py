"""HADES tests (test__hades_module.c style: analysis+synthesis run, params
behave physically)."""
import numpy as np
import pytest

from spatial_audio_framework_tpu.modules import hades
from spatial_audio_framework_tpu.modules.hrir import default_hrirs


@pytest.fixture(scope="module")
def ana():
    return hades.HadesAnalysis()


def _binaural_input(azi_deg, elev_deg, T, seed=0):
    """Simulate a plane wave arriving at the binaural 'array' (default HRIRs)."""
    hrirs, dirs, fs = default_hrirs()
    from spatial_audio_framework_tpu.utils.geometry import unit_sph2cart
    u = np.asarray(unit_sph2cart(dirs.astype(np.float64), degrees=True))
    v = np.asarray(unit_sph2cart(np.array([[azi_deg, elev_deg]]), degrees=True))[0]
    idx = np.argmax(u @ v)
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1, 1, T).astype(np.float32)
    from scipy.signal import fftconvolve
    return np.stack([fftconvolve(s, hrirs[idx, e])[:T] for e in range(2)])


def test_comedie_extremes():
    # single plane wave: one dominant eigenvalue → diffuseness ≈ 0
    assert hades.comedie(np.array([4.0, 0.0, 0.0, 0.0])) < 0.05
    # isotropic: equal eigenvalues → diffuseness 1
    assert hades.comedie(np.ones(4)) == pytest.approx(1.0)
    assert hades.comedie(np.zeros(4)) == 1.0


def test_hades_analysis_params(ana):
    x = _binaural_input(-90.0, 0.0, 32 * 128)
    params = None
    for i in range(3):  # let the SCM average settle
        params, sigs = ana.apply(x)
    assert params.diffuseness.shape == (ana.n_bands,)
    sel = slice(10, 60)  # mid bands
    assert params.diffuseness[sel].mean() < 0.7
    # DoA estimates point left-ish in mid bands
    azi = ana.grid_dirs_deg[params.doa_idx[sel], 0]
    frac_left = np.mean(np.abs(azi + 90) < 60)
    assert frac_left > 0.5, azi


@pytest.mark.goldens
def test_hades_synthesis_runs(ana):
    syn = hades.HadesSynthesis(ana, beam_option=hades.HADES_BEAMFORMER_FILTER_AND_SUM)
    x = _binaural_input(60.0, 0.0, 16 * 128, seed=2)
    params, sigs = ana.apply(x)
    y = syn.apply(params, sigs)
    assert y.shape == (2, x.shape[1]) and np.isfinite(y).all()
    assert (y ** 2).sum() > 0
    # radial editor: kill everything → near-silent direct stream
    ed = hades.HadesRadialEditor(ana.grid_dirs_deg)
    params2 = ed.apply(params, np.full(360, -60.0))
    assert params2.gains_dir.max() < 0.01


@pytest.mark.goldens
def test_hades_synthesis_bmvdr(ana):
    syn = hades.HadesSynthesis(ana, beam_option=hades.HADES_BEAMFORMER_BMVDR,
                               enable_cm=False)
    x = _binaural_input(0.0, 0.0, 16 * 128, seed=3)
    params, sigs = ana.apply(x)
    y = syn.apply(params, sigs)
    assert np.isfinite(y).all() and (y ** 2).sum() > 0


@pytest.mark.goldens
def test_fused_pipeline_matches_two_stage():
    """HadesPipeline (single-dispatch analysis+synthesis, params on device)
    and the host-marshalled two-stage path produce the same audio; the
    chunked scan path matches too."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.modules import hades as HD

    rng = np.random.default_rng(5)
    ana = HD.HadesAnalysis()
    syn = HD.HadesSynthesis(ana, beam_option=HD.HADES_BEAMFORMER_BMVDR)
    pipe = HD.HadesPipeline(ana, syn)
    x = rng.uniform(-1, 1, (3, ana.n_mics, ana.blocksize)).astype(np.float32)

    st = pipe.init_state()
    ys_fused = []
    for i in range(3):
        y, st = pipe.process(st, jnp.asarray(x[i]))
        ys_fused.append(np.asarray(y))

    ana2 = HD.HadesAnalysis()
    syn2 = HD.HadesSynthesis(ana2, beam_option=HD.HADES_BEAMFORMER_BMVDR)
    for i in range(3):
        p, s = ana2.apply(x[i])
        y2 = syn2.apply(p, s)
        assert np.abs(ys_fused[i] - y2).max() <= 1e-4, i

    ana3 = HD.HadesAnalysis()
    syn3 = HD.HadesSynthesis(ana3, beam_option=HD.HADES_BEAMFORMER_BMVDR)
    pipe3 = HD.HadesPipeline(ana3, syn3)
    yc, _ = pipe3.process_chunk(pipe3.init_state(), jnp.asarray(x))
    assert np.abs(np.asarray(yc) - np.stack(ys_fused)).max() <= 1e-5


@pytest.mark.goldens
def test_batched_pipeline_matches_per_instance():
    """process_chunk_batched (N instances in one dispatch)
    is numerically identical to running each instance separately."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.modules import hades as HD

    rng = np.random.default_rng(9)
    ana = HD.HadesAnalysis()
    syn = HD.HadesSynthesis(ana, beam_option=HD.HADES_BEAMFORMER_BMVDR)
    pipe = HD.HadesPipeline(ana, syn)
    N, NB = 3, 2
    x = rng.uniform(-1, 1, (N, NB, ana.n_mics, ana.blocksize)).astype(
        np.float32)

    yb, stb = pipe.process_chunk_batched(pipe.init_state_batched(N),
                                         jnp.asarray(x))
    assert yb.shape == (N, NB, 2, ana.blocksize)
    for n in range(N):
        ys, _ = pipe.process_chunk(pipe.init_state(), jnp.asarray(x[n]))
        np.testing.assert_allclose(np.asarray(yb[n]), np.asarray(ys),
                                   atol=1e-5)  # vmap changes einsum lowering


@pytest.mark.goldens
def test_fused_chunk_matches_scan_chunk():
    """The scan-free time-batched chunk (one-pole recurrences as triangular
    matmuls, afSTFT over the concatenated chunk) is numerically equivalent
    to the per-block lax.scan path — only the recurrences' summation order
    differs."""
    import jax
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.modules import hades as HD

    rng = np.random.default_rng(11)
    ana = HD.HadesAnalysis()
    syn = HD.HadesSynthesis(ana, beam_option=HD.HADES_BEAMFORMER_BMVDR)
    pipe = HD.HadesPipeline(ana, syn)
    NB = 5
    x = jnp.asarray(rng.uniform(
        -1, 1, (NB, ana.n_mics, ana.blocksize)).astype(np.float32))
    eq, bal = pipe._controls()
    st_f, ys_f = pipe._jit_chunk(pipe.init_state(), x, eq, bal)
    st_s, ys_s = pipe._jit_chunk_scan(pipe.init_state(), x, eq, bal)
    np.testing.assert_allclose(np.asarray(ys_f), np.asarray(ys_s), atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(st_f),
                    jax.tree_util.tree_leaves(st_s)):
        # Cx entries are energy-scale (O(10)); the entrywise path sums the
        # hop contraction in a different order than the scan's einsum
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)


@pytest.mark.goldens
def test_fused_pipeline_matches_c_golden():
    """The production fused pipeline (scan-free time-batched chunk) hits the
    compiled C reference on the 6-mic golden configuration end-to-end — not
    just the two-stage host-marshalled path that test_c_goldens pins."""
    import os

    import jax.numpy as jnp

    from spatial_audio_framework_tpu.modules import hades as HD
    from spatial_audio_framework_tpu.modules.hrir import default_hrirs

    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "c_goldens.npz"))
    ana = HD.HadesAnalysis(fs=48000.0, hop=64,
                           h_array=np.asarray(g["hds_h_array"], np.float32),
                           grid_dirs_deg=np.asarray(g["hds_grid_dirs_deg"],
                                                    np.float64),
                           blocksize=256, hybrid=False, low_delay=True)
    hrirs, hrir_dirs, hfs = default_hrirs()
    syn = HD.HadesSynthesis(
        ana, hrirs=hrirs, hrir_dirs_deg=hrir_dirs, hrir_fs=hfs,
        beam_option=HD.HADES_BEAMFORMER_BMVDR, ref_indices=(1, 5),
        enable_cm=True, interp_option=HD.HADES_HRTF_INTERP_NEAREST)
    pipe = HD.HadesPipeline(ana, syn)
    x = np.asarray(g["hds_in"], np.float32).reshape(ana.n_mics, 16, 256)
    x_blocks = jnp.asarray(np.moveaxis(x, 1, 0))
    ys, _ = pipe.process_chunk(pipe.init_state(), x_blocks)
    out = np.moveaxis(np.asarray(ys), 0, 1).reshape(2, -1)
    ref = np.asarray(g["hds_out_bin"]).reshape(2, -1)
    assert np.abs(out - ref).max() <= 1e-3  # two-stage path observes 2.9e-4
