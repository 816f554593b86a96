"""Failure-path behavior: saf-style Config validation and
the reference's SOFA-load-failure → default-HRIRs graceful fallback
(ambi_bin.c:209-218)."""
import numpy as np
import pytest

from spatial_audio_framework_tpu.models import _common as C


def test_config_validation_order_bounds():
    from spatial_audio_framework_tpu.models import ambi_bin, ambi_enc, powermap

    with pytest.raises(C.SafConfigError, match="MAX_SH_ORDER"):
        ambi_bin.AmbiBinConfig(order=8)
    with pytest.raises(C.SafConfigError, match="order"):
        ambi_enc.AmbiEncConfig(order=0)
    with pytest.raises(C.SafConfigError, match="master_order"):
        powermap.PowermapConfig(master_order=9)
    # the full legal range constructs fine
    for o in range(1, C.MAX_SH_ORDER + 1):
        ambi_enc.AmbiEncConfig(order=o)


def test_config_validation_channels_fs_enums():
    from spatial_audio_framework_tpu.models import ambi_bin, binauraliser, panner

    with pytest.raises(C.SafConfigError, match="MAX_NUM_CHANNELS"):
        binauraliser.BinauraliserConfig(n_sources=65)
    with pytest.raises(C.SafConfigError, match="n_sources"):
        panner.PannerConfig(n_sources=0)
    with pytest.raises(C.SafConfigError, match="fs"):
        ambi_bin.AmbiBinConfig(fs=0.0)
    with pytest.raises(C.SafConfigError, match="norm"):
        ambi_bin.AmbiBinConfig(norm="bogus")
    with pytest.raises(C.SafConfigError, match="ch_ordering"):
        ambi_bin.AmbiBinConfig(ch_ordering="wxyz")


def test_config_validation_non_integer():
    from spatial_audio_framework_tpu.models import ambi_enc, panner

    with pytest.raises(C.SafConfigError, match="integer"):
        ambi_enc.AmbiEncConfig(order=2.5)
    with pytest.raises(C.SafConfigError, match="integer"):
        panner.PannerConfig(n_sources=1.5)


def test_find_ls_triplets_too_few_speakers():
    """The C saf_print_error's on a failed hull (saf_vbap.c:533-537); here
    a clear ValueError instead of an opaque NoneType/QhullError."""
    from spatial_audio_framework_tpu.modules import vbap

    with pytest.raises(ValueError, match="4 loudspeaker"):
        vbap.find_ls_triplets(np.array([[0.0, 0.0], [90.0, 0.0],
                                        [-90.0, 0.0]]))


def test_load_hrirs_fallback_on_bad_path():
    from spatial_audio_framework_tpu.modules import hrir as hrir_mod

    with pytest.warns(UserWarning, match="Using default HRIR data instead"):
        h, d, fs, used_default = hrir_mod.load_hrirs("/nonexistent/file.sofa")
    assert used_default
    hd, dd, fsd = hrir_mod.default_hrirs()
    assert h.shape == hd.shape and fs == fsd


def test_load_hrirs_fallback_on_wrong_receivers(tmp_path):
    from spatial_audio_framework_tpu.modules import hrir as hrir_mod
    from spatial_audio_framework_tpu.modules import sofa as SOFA

    # a valid SOFA file with 4 receivers — not an HRIR set
    path = str(tmp_path / "not_hrirs.sofa")
    SOFA.sofa_save(path, np.zeros((10, 4, 32)), 48000.0,
                   np.zeros((10, 3)))
    h, d, fs, used_default = hrir_mod.load_hrirs(path)
    assert used_default


def test_design_survives_bad_sofa_path():
    """ambi_bin/binauraliser design with an unloadable sofa_filepath matches
    the default-set design exactly (the reference's behavior)."""
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import ambi_bin

    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    w_bad = ambi_bin.design_ri(cfg, sofa_filepath="/no/such/file.sofa")
    w_def = ambi_bin.design_ri(cfg)
    for a, b in zip(w_bad, w_def):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_design_consumes_good_sofa(tmp_path):
    from spatial_audio_framework_tpu.models import binauraliser as BIN
    from spatial_audio_framework_tpu.modules import hrir as hrir_mod
    from spatial_audio_framework_tpu.modules import sofa as SOFA

    h, d, fs = hrir_mod.default_hrirs()
    sub = slice(0, 836, 2)  # a distinguishable subset
    path = str(tmp_path / "subset.sofa")
    SOFA.sofa_save(path, np.asarray(h[sub], np.float64), float(fs),
                   np.concatenate([d[sub], np.ones((d[sub].shape[0], 1))], 1))
    hrirs, dirs, fs2, used_default = hrir_mod.load_hrirs(path)
    assert not used_default and hrirs.shape[0] == h[sub].shape[0]
    cfg = BIN.BinauraliserConfig(n_sources=1)
    w = BIN.design_ri(cfg, sofa_filepath=path)
    assert w.itds.shape[0] == h[sub].shape[0]
