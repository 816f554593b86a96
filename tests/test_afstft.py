"""afSTFT round-trip tests, mirroring the reference's own recipe
(test/src/test__resources.c:27-89): white-noise perfect reconstruction within
0.01 absolute after compensating the documented processing delay."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spatial_audio_framework_tpu.ops.afstft import AfSTFT


@pytest.mark.parametrize("hybrid,low_delay", [(True, False), (False, False),
                                              (True, True), (False, True)])
def test_reconstruction(hybrid, low_delay):
    hop = 128
    cfg = AfSTFT(hop=hop, hybrid=hybrid, low_delay=low_delay)
    rng = np.random.default_rng(0)
    n_ch, n_hops = 4, 80
    x = (rng.uniform(-1, 1, (n_ch, n_hops * hop))).astype(np.float32)
    st = cfg.init_state(n_ch, n_ch)
    spec, st = jax.jit(cfg.analysis)(st, jnp.asarray(x))
    assert spec.shape == (cfg.n_bands, n_ch, n_hops)
    y, st = jax.jit(cfg.synthesis)(st, spec)
    y = np.asarray(y)
    d = cfg.proc_delay
    err = np.abs(y[:, d:] - x[:, : x.shape[1] - d])
    assert err.max() < 0.01, err.max()


def test_block_size_invariance():
    """Processing in many small blocks == one big block (state correctness)."""
    hop = 128
    cfg = AfSTFT(hop=hop)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64 * hop)).astype(np.float32)

    st = cfg.init_state(2, 2)
    big, _ = jax.jit(cfg.analysis)(st, jnp.asarray(x))

    ana8 = jax.jit(cfg.analysis)
    st = cfg.init_state(2, 2)
    outs = []
    for i in range(0, 64, 8):
        o, st = ana8(st, jnp.asarray(x[:, i * hop:(i + 8) * hop]))
        outs.append(np.asarray(o))
    small = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(np.asarray(big), small, atol=1e-5)


def test_centre_freqs_against_reference_table():
    """First/last/representative values of the 48 kHz hybrid table
    (afSTFTlib.c:54-55)."""
    cfg = AfSTFT(hop=128, hybrid=True)
    f = cfg.centre_freqs(48000.0)
    assert f.shape == (133,)
    ref = {0: 0.0, 1: 140.644316361, 2: 234.355478108, 8: 796.855543885,
           9: 937.500032020, 10: 1125.000017338, 132: 24000.0}
    for k, v in ref.items():
        assert abs(f[k] - v) < 0.5, (k, f[k], v)


def test_proc_delay_values():
    assert AfSTFT(128, hybrid=True).proc_delay == 12 * 128
    assert AfSTFT(128, hybrid=False).proc_delay == 9 * 128
    assert AfSTFT(128, hybrid=True, low_delay=True).proc_delay == 7 * 128
    assert AfSTFT(128, hybrid=False, low_delay=True).proc_delay == 4 * 128


def test_matmul_dft_impl_matches_fft():
    """The DFT-as-matmul path (the matmul form the afSTFT's rDFT matrices
    and the fused render kernel use) must match the native-FFT path."""
    from spatial_audio_framework_tpu.ops.fft import force_dft_impl, rfft_op, irfft_op

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((3, 100)).astype(np.float32))
    with force_dft_impl("fft"):
        a = np.asarray(rfft_op(x, 256))
        xa = np.asarray(irfft_op(jnp.asarray(a), 256))
    with force_dft_impl("matmul"):
        b = np.asarray(rfft_op(x, 256))
        xb = np.asarray(irfft_op(jnp.asarray(a), 256))
    np.testing.assert_allclose(a, b, atol=2e-4)
    np.testing.assert_allclose(xa, xb, atol=1e-5)

    # full afSTFT round trip under the matmul implementation
    cfg = AfSTFT(hop=128)
    xx = rng.uniform(-1, 1, (2, 40 * 128)).astype(np.float32)
    with force_dft_impl("matmul"):
        st = cfg.init_state(2, 2)
        spec, st = jax.jit(cfg.analysis)(st, jnp.asarray(xx))
        y, st = jax.jit(cfg.synthesis)(st, spec)
        y = np.asarray(y)
    d = cfg.proc_delay
    assert np.abs(y[:, d:] - xx[:, : xx.shape[1] - d]).max() < 0.01


@pytest.mark.parametrize("impl", ["fft", "matmul"])
def test_irfft_ignores_edge_imaginary_parts(impl):
    """The imaginary parts of the DC and Nyquist bins do not contribute to
    the inverse real DFT (saf_rfft and numpy semantics), on either DFT
    implementation."""
    from spatial_audio_framework_tpu.ops.fft import force_dft_impl, irfft_op

    rng = np.random.default_rng(3)
    X = (rng.standard_normal((5, 129))
         + 1j * rng.standard_normal((5, 129))).astype(np.complex64)
    with force_dft_impl(impl):
        y = np.asarray(irfft_op(jnp.asarray(X), 256))
    np.testing.assert_allclose(y, np.fft.irfft(X, 256), atol=1e-5)
