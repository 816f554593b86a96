"""Per-call matmul precision plumbing (ops/precision.py).

The process-time matmul mode must be a per-call/config argument threaded all
the way into the XLA matmuls — not import-frozen env state.  On the CPU every mode computes in float32, so the
tests read the precision each traced dot carries instead of its numbers;
the measured error of each mode on the GPU is in PERF.md.
"""
import jax
import numpy as np
import pytest

import jax.numpy as jnp

from spatial_audio_framework_tpu.models import ambi_bin
from spatial_audio_framework_tpu.ops import precision as _prec


def _render(mode, wri, x):
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls",
                                 matmul_precision=mode)
    st = ambi_bin.init_state_batched(cfg, x.shape[0])
    y, _ = ambi_bin.process_ri_batched(cfg, wri, st, x)
    return np.asarray(y)


@pytest.fixture(scope="module")
def flagship_block():
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    wri = ambi_bin.design_ri(cfg)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (4, cfg.nsh, 16 * 128))
                    .astype(np.float32))
    return wri, x


@pytest.mark.goldens
@pytest.mark.parametrize("mode", ["default", "high", "highest"])
def test_mxu_mode_reaches_the_kernel(flagship_block, mode):
    """The config's mode reaches every matmul/einsum of the batched render
    (and the render still runs at it)."""
    wri, x = flagship_block
    jx = _xla_precisions(mode, wri, x)
    want = {"default": "Precision.DEFAULT", "high": "Precision.HIGH",
            "highest": "Precision.HIGHEST"}[mode]
    assert f"precision=({want}, {want})" in jx
    others = {"Precision.DEFAULT", "Precision.HIGH",
              "Precision.HIGHEST"} - {want}
    for other in others:
        assert f"precision=({other}, {other})" not in jx
    assert np.isfinite(_render(mode, wri, x)).all()


def _xla_precisions(mode, wri, x):
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls",
                                 matmul_precision=mode)
    st = ambi_bin.init_state_batched(cfg, x.shape[0])
    return str(jax.make_jaxpr(lambda w, s, xx: ambi_bin.process_ri_batched(
        cfg, w, s, xx))(wri, st, x))


def test_none_follows_process_default(flagship_block):
    wri, x = flagship_block
    old = _prec.hot_mode()
    try:
        _prec.set_hot_precision("highest")
        j_none = _xla_precisions(None, wri, x)
        assert j_none == _xla_precisions("highest", wri, x)
        assert "Precision.HIGHEST" in j_none
        # switching the process default AFTER traces exist must still take
        # effect: mode resolution happens outside the jit boundary
        _prec.set_hot_precision("high")
        j_none2 = _xla_precisions(None, wri, x)
        assert j_none2 == _xla_precisions("high", wri, x)
        assert "Precision.HIGHEST" not in j_none2
        assert "Precision.HIGH" in j_none2
    finally:
        _prec.set_hot_precision(old)


def test_invalid_mode_rejected():
    with pytest.raises(ValueError, match="default|high|highest"):
        _prec.normalize_mode("fast")
    with pytest.raises(ValueError):
        _prec.normalize_mode("f32x3")
    from spatial_audio_framework_tpu.models._common import SafConfigError
    with pytest.raises(SafConfigError, match="invalid matmul precision"):
        ambi_bin.AmbiBinConfig(order=1, matmul_precision="bogus")


def test_env_fallback_never_crashes_import(monkeypatch):
    monkeypatch.setenv("SAF_MATMUL_PRECISION", "garbage")
    with pytest.warns(UserWarning, match="falling back"):
        assert _prec._mode_from_env() == "highest"
    monkeypatch.setenv("SAF_MATMUL_PRECISION", "HIGH")
    assert _prec._mode_from_env() == "high"
    monkeypatch.delenv("SAF_MATMUL_PRECISION")
    assert _prec._mode_from_env() == "highest"
