"""Multi-device sharding tests on the virtual 8-device CPU mesh.

conftest.py forces the CPU platform with 8 virtual devices, so these tests
exercise the real pjit/shard_map partitioning (XLA inserts the same
collectives it would over ICI).  Parity is asserted between sharded and
single-device runs of the identical batched computation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spatial_audio_framework_tpu.models import ambi_bin, binauraliser
from spatial_audio_framework_tpu.parallel import mesh as pmesh
from spatial_audio_framework_tpu.parallel.streaming import render_signal


def test_eight_devices_provisioned():
    assert jax.device_count() >= 8
    assert jax.devices()[0].platform == "cpu"


def test_make_mesh_dp_only():
    m = pmesh.make_mesh(8)
    assert m.axis_names == ("dp", "tp")
    assert m.shape["dp"] == 8 and m.shape["tp"] == 1


def test_make_mesh_dp_tp():
    m = pmesh.make_mesh(8, tp=2)
    assert m.shape["dp"] == 4 and m.shape["tp"] == 2
    m2 = pmesh.make_mesh(8, dp=2, tp=4)
    assert m2.shape["dp"] == 2 and m2.shape["tp"] == 4


def test_make_mesh_rejects_nonfactoring():
    with pytest.raises(AssertionError):
        pmesh.make_mesh(8, dp=3, tp=2)


def test_stream_sharding_and_shard_leading():
    m = pmesh.make_mesh(8)
    sh = pmesh.stream_sharding(m)
    assert sh.spec == P("dp", None, None)
    sh_tp = pmesh.stream_sharding(m, shard_channels=True)
    assert sh_tp.spec == P("dp", "tp", None)

    tree = {"a": jnp.zeros((8, 3)), "b": jnp.zeros((8, 2, 5))}
    placed = pmesh.shard_leading(tree, m)
    for leaf in jax.tree.leaves(placed):
        assert leaf.sharding.spec[0] == "dp"
    # leading axis is split over all 8 devices
    assert placed["a"].addressable_shards[0].data.shape == (1, 3)


# ---------------------------------------------------------------------------
# ambi_bin: shard_map'd RI fast path, 2-step state carry, parity vs 1-device
# ---------------------------------------------------------------------------

def _ambi_bin_setup(n_streams=8, n_hops=2):
    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    wri = ambi_bin.design_ri(cfg)
    st = ambi_bin.init_state_batched(cfg, n_streams)
    T = n_hops * cfg.hop
    x = jnp.asarray(np.random.default_rng(7)
                    .uniform(-1, 1, (n_streams, cfg.nsh, T)).astype(np.float32))
    return cfg, wri, st, x


@pytest.mark.goldens
def test_ambi_bin_shard_map_parity_and_state_carry():
    cfg, wri, st, x = _ambi_bin_setup()
    mesh = pmesh.make_mesh(8)

    def step(w, s, xx):
        return ambi_bin.process_ri_batched(cfg, w, s, xx)

    # single-device reference: two consecutive blocks
    y1_ref, st1_ref = jax.jit(step)(wri, st, x)
    y2_ref, _ = jax.jit(step)(wri, st1_ref, x)

    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(None), P("dp"), P("dp")),
        out_specs=P("dp"), check_vma=False)
    x_s = jax.device_put(x, NamedSharding(mesh, P("dp", None, None)))
    st_s = pmesh.shard_leading(st, mesh)
    y1, st1 = jax.jit(sharded)(wri, st_s, x_s)
    y2, _ = jax.jit(sharded)(wri, st1, x_s)

    np.testing.assert_allclose(np.asarray(y1), np.asarray(y1_ref),
                               atol=1e-6, rtol=1e-5)
    # state carry-over across steps must match too
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y2_ref),
                               atol=1e-6, rtol=1e-5)
    assert not np.allclose(np.asarray(y2), np.asarray(y1))  # state mattered


@pytest.mark.goldens
def test_ambi_bin_namedsharding_dp_tp_autopartition():
    """pjit auto-partitioning over a dp×tp mesh: streams data-parallel,
    SH channels tensor-parallel (decode contraction reduces over 'tp')."""
    cfg, wri, st, x = _ambi_bin_setup()
    mesh = pmesh.make_mesh(8, tp=2)

    def step(w, s, xx):
        return ambi_bin.process_ri_batched(cfg, w, s, xx)

    y_ref, _ = jax.jit(step)(wri, st, x)

    x_s = jax.device_put(x, NamedSharding(mesh, P("dp", "tp", None)))
    wri_s = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P(None, None, "tp"))),
        wri)
    st_s = jax.tree.map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P("dp", "tp", *([None] * (a.ndim - 2))))
            if a.ndim >= 2 and a.shape[1] == cfg.nsh
            else NamedSharding(mesh, P("dp", *([None] * (a.ndim - 1))))), st)
    y, _ = jax.jit(step)(wri_s, st_s, x_s)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# binauraliser: per-stream mixing matrices under shard_map
# ---------------------------------------------------------------------------

@pytest.mark.goldens
def test_binauraliser_shard_map_parity():
    n_streams, n_src = 8, 3
    cfg = binauraliser.BinauraliserConfig(n_sources=n_src)
    w = binauraliser.design_ri(cfg)
    st = binauraliser.init_state_batched(cfg, n_streams)
    T = 2 * cfg.hop
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-1, 1, (n_streams, n_src, T)).astype(np.float32))
    dirs = jnp.asarray(np.stack([
        rng.uniform(-180, 180, (n_streams, n_src)),
        rng.uniform(-90, 90, (n_streams, n_src))], axis=-1).astype(np.float32))

    def step(s, xx, dd):
        return binauraliser.process_ri_batched(cfg, w, s, xx, dd)

    y_ref, st_ref = jax.jit(step)(st, x, dirs)

    mesh = pmesh.make_mesh(8)
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp")),
        out_specs=P("dp"), check_vma=False)
    st_s = pmesh.shard_leading(st, mesh)
    x_s = jax.device_put(x, NamedSharding(mesh, P("dp", None, None)))
    d_s = jax.device_put(dirs, NamedSharding(mesh, P("dp", None, None)))
    y, st2 = jax.jit(sharded)(st_s, x_s, d_s)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=1e-6, rtol=1e-5)
    # carried state parity as well (spot-check one leaf)
    l_ref = jax.tree.leaves(st_ref)[0]
    l_sh = jax.tree.leaves(st2)[0]
    np.testing.assert_allclose(np.asarray(l_sh), np.asarray(l_ref),
                               atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# streaming.render_signal
# ---------------------------------------------------------------------------

@pytest.mark.goldens
def test_render_signal_matches_blockwise_loop():
    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    wri = ambi_bin.design_ri(cfg)
    T, B = 4 * cfg.hop, 2 * cfg.hop
    x = jnp.asarray(np.random.default_rng(11)
                    .uniform(-1, 1, (cfg.nsh, T)).astype(np.float32))

    def proc(st, blk):
        y, st = ambi_bin.process_ri(cfg, wri, st, blk)
        return y, st

    st0 = ambi_bin.init_state_ri(cfg)
    y_scan, _ = jax.jit(lambda s, xx: render_signal(proc, s, xx, B))(st0, x)

    st = ambi_bin.init_state_ri(cfg)
    outs = []
    for i in range(T // B):
        y, st = jax.jit(proc)(st, x[:, i * B:(i + 1) * B])
        outs.append(np.asarray(y))
    y_loop = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(np.asarray(y_scan), y_loop,
                               atol=1e-6, rtol=1e-5)


@pytest.mark.goldens
def test_render_signal_sharded_streams():
    """render_signal composes with stream sharding: scan over blocks while
    streams stay data-parallel on the mesh."""
    cfg = ambi_bin.AmbiBinConfig(order=1, method="ls")
    wri = ambi_bin.design_ri(cfg)
    n_streams = 8
    T, B = 2 * cfg.hop, cfg.hop
    x = jnp.asarray(np.random.default_rng(13).uniform(
        -1, 1, (n_streams, cfg.nsh, T)).astype(np.float32))
    st0 = ambi_bin.init_state_batched(cfg, n_streams)

    def proc(st, blk):
        y, st = ambi_bin.process_ri_batched(cfg, wri, st, blk)
        return y, st

    run = jax.jit(lambda s, xx: render_signal(proc, s, xx, B))
    y_ref, _ = run(st0, x)

    mesh = pmesh.make_mesh(8)
    x_s = jax.device_put(x, pmesh.stream_sharding(mesh))
    st_s = pmesh.shard_leading(st0, mesh)
    y_s, _ = run(st_s, x_s)
    np.testing.assert_allclose(np.asarray(y_s), np.asarray(y_ref),
                               atol=1e-6, rtol=1e-5)


def test_powermap_band_sharded_grouping_parity():
    """Band-parallel analyser sharding (the 'sequence-parallel' axis of the
    TF-domain analysers): the 133 afSTFT bands shard over a 7-device mesh
    (133 = 7*19); the per-band SCMs stay fully local, while the
    order-truncated covariance grouping reduces over the sharded band axis
    (XLA inserts the all-reduce) before the MUSIC map.  Parity vs the
    single-device run is exact to f32."""
    from spatial_audio_framework_tpu.models import powermap as PM
    from spatial_audio_framework_tpu.modules import sh_est

    cfg = PM.PowermapConfig(master_order=3, mode=PM.PM_MUSIC, n_sources=2,
                            norm="n3d", analysis_grid="tdesign")
    w = PM.design(cfg)
    n_bands, nsh, H = 133, cfg.nsh, 16
    rng = np.random.default_rng(11)
    sre = jnp.asarray(rng.standard_normal((n_bands, nsh, H)).astype(np.float32))
    sim = jnp.asarray(rng.standard_normal((n_bands, nsh, H)).astype(np.float32))
    eq = jnp.ones(n_bands, jnp.float32)

    def band_core(sre, sim, eq):
        # per-band SCM (local to each band shard)
        re = (jnp.einsum("bsh,bth->bst", sre, sre)
              + jnp.einsum("bsh,bth->bst", sim, sim)) / H
        im = (jnp.einsum("bsh,bth->bst", sim, sre)
              - jnp.einsum("bsh,bth->bst", sre, sim)) / H
        m = w.band_mask * (1e3 * eq)[:, None]
        C_grp = (jnp.einsum("bi,bj,bij->ij", m, w.band_mask, re),
                 jnp.einsum("bi,bj,bij->ij", m, w.band_mask, im))
        return sh_est.generate_music_map_ri(C_grp, w.Y_grid, cfg.n_sources)

    ref = np.asarray(jax.jit(band_core)(sre, sim, eq))

    mesh = pmesh.make_mesh(7)  # 7 devices: 133 bands shard evenly (19 each)
    band_sh = NamedSharding(mesh, P("dp"))
    spec_sh = NamedSharding(mesh, P("dp", None, None))
    sre_s = jax.device_put(sre, spec_sh)
    sim_s = jax.device_put(sim, spec_sh)
    eq_s = jax.device_put(eq, band_sh)
    out = np.asarray(jax.jit(band_core)(sre_s, sim_s, eq_s))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * ref.max())
