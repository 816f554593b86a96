"""Split real/imaginary afSTFT path: exact equivalence with the complex64
pipeline (ops/afstft_ri.py is the complex-free variant for runtimes with
incomplete complex support and for mixed-precision experiments)."""
import numpy as np
import jax
import pytest
import jax.numpy as jnp

from spatial_audio_framework_tpu.models import ambi_bin
from spatial_audio_framework_tpu.ops import afstft_ri as ri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT


@pytest.mark.goldens
def test_analysis_synthesis_ri_equivalence():
    rng = np.random.default_rng(0)
    for hybrid, ld in ((True, False), (False, False), (True, True)):
        bank = AfSTFT(hop=128, hybrid=hybrid, low_delay=ld)
        n_ch, H = 3, 8
        x = rng.uniform(-1, 1, (n_ch, H * 128)).astype(np.float32)
        st_c = bank.init_state(n_ch, n_ch)
        st_r = ri.init_state_ri(bank, n_ch, n_ch)

        spec, st_c = jax.jit(bank.analysis)(st_c, jnp.asarray(x))
        (sre, sim), st_r = jax.jit(
            lambda s, xx: ri.analysis_ri(bank, s, xx))(st_r, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(sre), np.real(spec), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sim), np.imag(spec), atol=1e-5)

        y_c, _ = jax.jit(bank.synthesis)(st_c, spec)
        y_r, _ = jax.jit(lambda s, Y: ri.synthesis_ri(bank, s, Y))(
            st_r, (sre, sim))
        np.testing.assert_allclose(np.asarray(y_r), np.asarray(y_c), atol=1e-5)


@pytest.mark.goldens
def test_ambi_bin_process_ri_equivalence():
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls", enable_rotation=True)
    w = ambi_bin.design(cfg)
    wri = ambi_bin.weights_ri(w)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (cfg.nsh, 16 * 128)).astype(np.float32)
    ypr = jnp.asarray([0.4, -0.1, 0.2], jnp.float32)

    st_c = ambi_bin.init_state(cfg)
    y_c, _ = jax.jit(lambda w_, s, xx, r: ambi_bin.process(cfg, w_, s, xx, r))(
        w, st_c, jnp.asarray(x), ypr)
    st_r = ambi_bin.init_state_ri(cfg)
    y_r, _ = jax.jit(
        lambda w_, s, xx, r: ambi_bin.process_ri(cfg, w_, s, xx, r))(
        wri, st_r, jnp.asarray(x), ypr)
    np.testing.assert_allclose(np.asarray(y_r), np.asarray(y_c), atol=1e-5)


@pytest.mark.goldens
def test_ambi_bin_batched_pallas_equivalence():
    """Stream-batched path equals the per-stream RI pipeline, and carries
    its state across blocks."""
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    wri = ambi_bin.design_ri(cfg)
    S, H = 3, 16
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (S, cfg.nsh, H * 128)).astype(np.float32)

    # reference: per-stream process_ri
    ys = []
    for s in range(S):
        st = ambi_bin.init_state_ri(cfg)
        y, _ = jax.jit(lambda w, st, xx: ambi_bin.process_ri(cfg, w, st, xx))(
            wri, st, jnp.asarray(x[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)

    stb2 = ambi_bin.init_state_batched(cfg, S)
    yb2, stb2 = ambi_bin.process_ri_batched(cfg, wri, stb2, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yb2), ref, atol=1e-5)
    # a second block for state carry
    y2b, _ = ambi_bin.process_ri_batched(cfg, wri, stb2, jnp.asarray(x))
    st1 = ambi_bin.init_state_ri(cfg)
    y1, st1 = ambi_bin.process_ri(cfg, wri, st1, jnp.asarray(x[0]))
    y2, _ = ambi_bin.process_ri(cfg, wri, st1, jnp.asarray(x[0]))
    np.testing.assert_allclose(np.asarray(y2b)[0], np.asarray(y2), atol=1e-5)


@pytest.mark.goldens
def test_batched_pallas_small_blocks_state_carry():
    """Blocks shorter than the 9-hop OLA tail (H=2) must carry state
    correctly: four 2-hop blocks equal one 8-hop block."""
    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    wri = ambi_bin.design_ri(cfg)
    S = 2
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (S, cfg.nsh, 8 * 128)).astype(np.float32)

    st = ambi_bin.init_state_batched(cfg, S)
    y_big, _ = ambi_bin.process_ri_batched(cfg, wri, st, jnp.asarray(x))
    st = ambi_bin.init_state_batched(cfg, S)
    ys = []
    for k in range(4):
        y, st = ambi_bin.process_ri_batched(
            cfg, wri, st, jnp.asarray(x[:, :, k * 256:(k + 1) * 256]))
        ys.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(ys, axis=-1),
                               np.asarray(y_big), atol=1e-5)


@pytest.mark.goldens
def test_binauraliser_batched_fast_path():
    """Stream-batched binauraliser fast path equals the per-stream reference
    process (rotation on, gains on)."""
    from spatial_audio_framework_tpu.models import binauraliser as B

    cfg = B.BinauraliserConfig(n_sources=2, enable_rotation=True)
    w = B.design(cfg)
    wri = B.design_ri(cfg)
    S = 2
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (S, 2, 16 * 128)).astype(np.float32)
    dirs = np.array([[[40.0, 10.0], [-70.0, 0.0]],
                     [[90.0, 0.0], [0.0, 45.0]]], np.float32)
    gains = np.array([[1.0, 0.5], [0.8, 1.0]], np.float32)
    ypr = np.array([[0.3, 0.0, 0.1], [-0.5, 0.2, 0.0]], np.float32)

    ys = []
    for s in range(S):
        st = B.init_state(cfg)
        y, _ = B.process(cfg, w, st, jnp.asarray(x[s]), jnp.asarray(dirs[s]),
                         jnp.asarray(gains[s]), jnp.asarray(ypr[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)

    stb = B.init_state_batched(cfg, S)
    yb, _ = B.process_ri_batched(cfg, wri, stb, jnp.asarray(x),
                                 jnp.asarray(dirs), jnp.asarray(gains),
                                 jnp.asarray(ypr))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=1e-4)


@pytest.mark.goldens
def test_roombinauraliser_batched_fast_path():
    from spatial_audio_framework_tpu.models import roombinauraliser as RB

    n_azi = 12
    azis = -180.0 + 360.0 * np.arange(n_azi) / n_azi
    dirs = np.stack([azis, np.zeros(n_azi)], -1)
    rng = np.random.default_rng(5)
    brirs = 0.02 * rng.standard_normal((1, n_azi, 2, 128)).astype(np.float32)
    brirs[:, :, 0, 4] += 1.0 + 0.5 * np.sin(np.radians(azis))
    brirs[:, :, 1, 4] += 1.0 - 0.5 * np.sin(np.radians(azis))
    cfg, w = RB.design(RB.RoomBinauraliserConfig(
        n_sources=1, fs=48000, enable_hrir_diff_eq=False), brirs, dirs, 48000)
    cfg2, wri = RB.design_ri(RB.RoomBinauraliserConfig(
        n_sources=1, fs=48000, enable_hrir_diff_eq=False), brirs, dirs, 48000)

    x = rng.uniform(-1, 1, (2, 1, 16 * 128)).astype(np.float32)
    ypr = np.array([[np.pi / 2, 0, 0], [-np.pi / 2, 0, 0]], np.float32)
    ys = []
    for s in range(2):
        st = RB.init_state(cfg)
        y, _ = RB.process(cfg, w, st, jnp.asarray(x[s]),
                          ypr=jnp.asarray(ypr[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = RB.init_state_batched(cfg, 2)
    yb, _ = RB.process_ri_batched(cfg2, wri, stb, jnp.asarray(x),
                                  ypr=jnp.asarray(ypr))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=1e-4)


@pytest.mark.goldens
def test_ambi_dec_batched_fast_path():
    from spatial_audio_framework_tpu.models import ambi_dec as D

    ls = np.array([[30.0, 0.0], [-30.0, 0.0], [110.0, 0.0], [-110.0, 0.0],
                   [0.0, 90.0]])
    cfg = D.AmbiDecConfig(master_order=1)
    w = D.design(cfg, ls)
    rng = np.random.default_rng(6)
    S = 2
    x = rng.uniform(-1, 1, (S, cfg.nsh, 16 * 128)).astype(np.float32)
    ys = []
    for s in range(S):
        st = D.init_state(cfg, ls.shape[0])
        y, _ = D.process(cfg, w, st, jnp.asarray(x[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    wri = D.design_ri(cfg, ls)
    stb = D.init_state_batched(cfg, S, ls.shape[0])
    yb, _ = D.process_ri_batched(cfg, wri, stb, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=1e-4)


@pytest.mark.goldens
def test_panner_batched_fast_path():
    from spatial_audio_framework_tpu.models import panner as P

    ls = np.array([[30.0, 0.0], [-30.0, 0.0], [110.0, 0.0], [-110.0, 0.0],
                   [0.0, 90.0]])
    cfg = P.PannerConfig(n_sources=2, n_loudspeakers=5)
    w = P.design(cfg, ls)
    rng = np.random.default_rng(7)
    S = 2
    x = rng.uniform(-1, 1, (S, 2, 16 * 128)).astype(np.float32)
    dirs = np.array([[[30.0, 0.0], [-110.0, 0.0]],
                     [[0.0, 45.0], [110.0, 0.0]]], np.float32)
    ypr = np.array([[0.2, 0.0, 0.0], [0.0, 0.1, 0.0]], np.float32)
    ys = []
    for s in range(S):
        st = P.init_state(cfg)
        y, _ = P.process(cfg, w, st, jnp.asarray(x[s]), jnp.asarray(dirs[s]),
                         jnp.asarray(ypr[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = P.init_state_batched(cfg, S, ls.shape[0])
    yb, _ = P.process_ri_batched(cfg, w, stb, jnp.asarray(x),
                                 jnp.asarray(dirs), jnp.asarray(ypr))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=1e-4)


@pytest.mark.goldens
def test_long_run_stability():
    """2000 blocks (≈5.3 s × 4 streams) through the fast path under lax.scan:
    bounded output, no NaN, state stays finite."""
    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    wri = ambi_bin.design_ri(cfg)
    S = 4
    rng = np.random.default_rng(8)
    xs = jnp.asarray(rng.uniform(-1, 1, (50, S, cfg.nsh, 2 * 128))
                     .astype(np.float32))

    def run(wri, st, xs):
        def body(st, xk):
            y, st = ambi_bin.process_ri_batched(cfg, wri, st, xk)
            return st, (jnp.max(jnp.abs(y)), jnp.sum(y * y))
        st, (peaks, es) = jax.lax.scan(body, st, xs)
        return st, peaks, es

    st = ambi_bin.init_state_batched(cfg, S)
    for _ in range(4):  # 4 × 50 scanned blocks
        st, peaks, es = jax.jit(run)(wri, st, xs)
    assert np.isfinite(np.asarray(peaks)).all()
    assert float(np.max(np.asarray(peaks))) < 100.0
    assert float(np.asarray(es)[-1]) > 0.0
    for leaf in jax.tree.leaves(st):
        assert np.isfinite(np.asarray(leaf)).all()


@pytest.mark.goldens
def test_ambi_drc_batched_fast_path():
    from spatial_audio_framework_tpu.models import ambi_drc as DRC

    cfg = DRC.AmbiDrcConfig(order=1, theshold_db=-20.0, ratio=8.0,
                            in_gain_db=6.0)
    rng = np.random.default_rng(9)
    S = 2
    x = rng.uniform(-1, 1, (S, cfg.nsh, 16 * 128)).astype(np.float32)
    ys = []
    for s in range(S):
        st = DRC.init_state(cfg)
        y, _ = DRC.process(cfg, st, jnp.asarray(x[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = DRC.init_state_batched(cfg, S)
    yb, stb = DRC.process_ri_batched(cfg, stb, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=2e-4)
    # second block continues the smoother state
    yb2, _ = DRC.process_ri_batched(cfg, stb, jnp.asarray(x))
    assert np.isfinite(np.asarray(yb2)).all()


@pytest.mark.goldens
def test_binauraliser_nf_batched_fast_path():
    from spatial_audio_framework_tpu.models import binauraliser_nf as NF

    cfg = NF.BinauraliserNFConfig(n_sources=2)
    w = NF.design(cfg)
    wri = NF.design_ri(cfg)
    rng = np.random.default_rng(10)
    S = 2
    x = rng.uniform(-1, 1, (S, 2, 16 * 128)).astype(np.float32)
    dirs = np.array([[[40.0, 0.0], [-60.0, 10.0]],
                     [[90.0, 0.0], [0.0, 0.0]]], np.float32)
    dists = np.array([[0.3, 1.5], [0.2, 2.5]], np.float32)
    ys = []
    for s in range(S):
        st = NF.init_state(cfg)
        y, _ = NF.process(cfg, w, st, jnp.asarray(x[s]), jnp.asarray(dirs[s]),
                          jnp.asarray(dists[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = NF.init_state_batched(cfg, S)
    yb, _ = NF.process_ri_batched(cfg, wri, stb, jnp.asarray(x),
                                  jnp.asarray(dirs), jnp.asarray(dists))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=1e-4)


@pytest.mark.goldens
def test_decorrelator_batched_fast_path():
    from spatial_audio_framework_tpu.models import decorrelator as DC

    cfg = DC.DecorrelatorConfig(n_channels=2, decor_amount=1.0)
    dd = DC.design(cfg)
    rng = np.random.default_rng(15)
    S = 2
    x = rng.uniform(-1, 1, (S, 2, 16 * 128)).astype(np.float32)
    ys = []
    for s in range(S):
        st = DC.init_state(cfg, dd)
        y, _ = DC.process(cfg, dd, st, jnp.asarray(x[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = DC.init_state_batched(cfg, dd, S)
    yb, _ = DC.process_ri_batched(cfg, dd, stb, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=2e-4)


@pytest.mark.goldens
def test_array2sh_batched_fast_path():
    from spatial_audio_framework_tpu.models import array2sh as A2

    # 8-sensor spherical array (two elevations x 4 azimuths)
    dirs = np.array([[a, e] for e in (-30.0, 30.0)
                     for a in (-135.0, -45.0, 45.0, 135.0)], np.float64)
    cfg = A2.Array2SHConfig(order=1)
    w = A2.design(cfg, dirs)
    wri = A2.design_ri(cfg, dirs)
    rng = np.random.default_rng(16)
    S = 2
    x = rng.uniform(-1, 1, (S, 8, 16 * 128)).astype(np.float32)
    ys = []
    for s in range(S):
        st = A2.init_state(cfg, 8)
        y, _ = A2.process(cfg, w, st, jnp.asarray(x[s]))
        ys.append(np.asarray(y))
    ref = np.stack(ys)
    stb = A2.init_state_batched(cfg, S, 8)
    yb, _ = A2.process_ri_batched(cfg, wri, stb, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(yb), ref, atol=2e-4)


def _complex_render(bank, xs, Mre, Mim):
    """Independent reference: per stream, the complex afSTFT analysis →
    complex per-band mixing → synthesis (ops.afstft), blocks carried."""
    M = np.asarray(Mre) + 1j * (0.0 if Mim is None else np.asarray(Mim))
    S, cin = xs[0].shape[:2]
    cout = M.shape[-2]
    ys = []
    for s in range(S):
        Ms = jnp.asarray((M[s] if M.ndim == 4 else M).astype(np.complex64))
        st = bank.init_state(cin, cout)
        out = []
        for x in xs:
            spec, st = bank.analysis(st, jnp.asarray(x[s]))
            mixed = jnp.einsum("bes,bsh->beh", Ms, spec,
                               precision=jax.lax.Precision.HIGHEST)
            y, st = bank.synthesis(st, mixed)
            out.append(np.asarray(y))
        ys.append(np.concatenate(out, -1))
    return np.stack(ys)


def _batched_render(bank, xs, Mre, Mim):
    S, cin = xs[0].shape[:2]
    st = ri.init_state_batched(bank, S, cin, Mre.shape[-2])
    out = []
    for x in xs:
        y, st = ri.render_tf_matrix_ri(bank, st, jnp.asarray(x), Mre, Mim)
        out.append(np.asarray(y))
    return np.concatenate(out, -1)


@pytest.mark.goldens
def test_render_tf_matrix_fused_matches_einsum_path():
    """The batched packed-spectrum render (one einsum over all bands)
    equals the complex afSTFT path, for shared and per-stream complex M,
    hybrid and non-hybrid banks, with state carry."""
    rng = np.random.default_rng(5)
    S, cin, cout, H = 3, 5, 2, 4
    for hybrid in (True, False):
        bank = AfSTFT(hop=128, hybrid=hybrid)
        nb = 133 if hybrid else 129
        for per_stream in (False, True):
            mshape = (S, nb, cout, cin) if per_stream else (nb, cout, cin)
            Mre = jnp.asarray(rng.standard_normal(mshape).astype(np.float32))
            Mim = jnp.asarray(rng.standard_normal(mshape).astype(np.float32))
            xs = [rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)
                  for _ in range(2)]
            np.testing.assert_allclose(_batched_render(bank, xs, Mre, Mim),
                                       _complex_render(bank, xs, Mre, Mim),
                                       atol=2e-5)


@pytest.mark.goldens
def test_render_fused_real_matrix_and_short_block():
    """Mim=None (real mixing) and H<9 blocks exercise the real-matrix
    einsum and the OLA tail-carry branch."""
    rng = np.random.default_rng(6)
    bank = AfSTFT(hop=128, hybrid=True)
    S, cin, cout = 2, 3, 2
    Mre = jnp.asarray(rng.standard_normal((133, cout, cin)).astype(np.float32))
    xs = [rng.uniform(-1, 1, (S, cin, 128)).astype(np.float32)
          for _ in range(12)]
    np.testing.assert_allclose(_batched_render(bank, xs, Mre, None),
                               _complex_render(bank, xs, Mre, None),
                               atol=2e-5)


def test_nonstandard_hop_falls_back_to_einsum_path():
    """A bank built with a hop other than the production 128 renders
    correctly on the batched path."""
    rng = np.random.default_rng(7)
    bank = AfSTFT(hop=64, hybrid=True)
    M = jnp.asarray(rng.standard_normal(
        (bank.n_bands, 2, 2)).astype(np.float32))
    xs = [rng.uniform(-1, 1, (1, 2, 1024)).astype(np.float32)
          for _ in range(2)]
    np.testing.assert_allclose(_batched_render(bank, xs, M, None),
                               _complex_render(bank, xs, M, None), atol=2e-5)


@pytest.mark.parametrize("H", [1, 5, 9, 20])
def test_overlap_add_matches_tiled_reference(H):
    """overlap_add (zero-padded contributions) equals a direct per-hop
    overlap-add, tail carry included, with and without a vmapped batch."""
    from spatial_audio_framework_tpu.ops.afstft import _windows
    hop = 128
    rng = np.random.default_rng(H)
    frame = rng.standard_normal((2, 3, H, 2 * hop)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 9 * hop)).astype(np.float32)
    w = np.asarray(_windows(hop, False)[1], np.float64)
    acc = np.zeros((2, 3, (H + 9) * hop))
    for h in range(H):
        for k in range(10):
            half = (k % 2) * hop
            acc[..., (h + k) * hop:(h + k + 1) * hop] += (
                frame[..., h, half:half + hop] * w[k * hop:(k + 1) * hop])
    acc[..., :9 * hop] += tail
    from spatial_audio_framework_tpu.ops.afstft import overlap_add
    ola = lambda f, t: overlap_add(f, t, w.astype(np.float32), hop)
    for fn in (ola, jax.vmap(ola)):
        y, new_tail = fn(jnp.asarray(frame), jnp.asarray(tail))
        np.testing.assert_allclose(np.asarray(y), acc[..., :H * hop],
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(new_tail), acc[..., H * hop:],
                                   atol=1e-5)
