"""Smoke test of the system on one NVIDIA GPU: the quickest proof that it
starts, renders and stays correct on the card.

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: the data-parallel render only

Phases, each reported on its own line:

1. device   — JAX's platform, kind and count, and the card's name and power
              limit from nvidia-smi.  Anything but a GPU stops the run.
2. flagship — 64 order-3 MagLS ambi_bin streams through process_ri_batched
              at full width: 64-hop (8192-sample) chunks, 8 chunks per
              dispatch under lax.scan, 3 dispatches carrying state; checked
              finite and against the complex reference path
              (``ambi_bin.process``, vmapped, HIGHEST precision).
3. c_parity — the committed C golden (order 4, rotated) through process_ri
              and through the batched path with the rotation folded in.
4. renderers — every other renderer once: finite and bounded output.
5. four     — (``--four`` only) streams sharded data-parallel over 4 cards
              with shard_map, compared with the same streams on one card.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed; any failure raises and exits non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4                  # C-parity / reference budget (max abs)
S_FLAG, H_FLAG, K_FLAG, D_FLAG = 64, 64, 8, 3
HOP = 128


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_dispatch(fn, *args, reps=5):
    """Median seconds per call of a compiled fn, ended by
    block_until_ready."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def chunked_input(rng, S, C, H, n_chunks):
    import jax.numpy as jnp
    return jnp.asarray(rng.uniform(-1, 1, (n_chunks, S, C, H * HOP))
                       .astype(np.float32))


def scan_render(render):
    """(state, xs (K, S, C, T)) -> (state, ys (K, S, Cout, T))."""
    import jax

    def step(st, xs):
        def body(s, x):
            y, s = render(s, x)
            return s, y
        return jax.lax.scan(body, st, xs)
    return step


def phase_flagship(rng):
    import jax
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import ambi_bin
    from spatial_audio_framework_tpu.ops import precision as _prec

    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    w = ambi_bin.design(cfg)
    wri = ambi_bin.design_ri(cfg)
    xs = chunked_input(rng, S_FLAG, cfg.nsh, H_FLAG, K_FLAG * D_FLAG)
    step = jax.jit(scan_render(
        lambda s, x: ambi_bin.process_ri_batched(cfg, wri, s, x)))
    st = ambi_bin.init_state_batched(cfg, S_FLAG)
    compiled = step.lower(st, xs[:K_FLAG]).compile()
    check("pallas" not in compiled.as_text().lower(),
          "a Pallas kernel (interpreted or not) is in the flagship graph")
    ys = []
    for d in range(D_FLAG):
        st, y = compiled(st, xs[d * K_FLAG:(d + 1) * K_FLAG])
        ys.append(y)
    y = np.asarray(jnp.concatenate(ys))
    check(np.isfinite(y).all(), "flagship output is not finite")

    with jax.default_matmul_precision("highest"):
        ref_step = jax.jit(scan_render(jax.vmap(
            lambda s, x: ambi_bin.process(cfg, w, s, x))))
        st_ref = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (S_FLAG,) + a.shape),
            ambi_bin.init_state(cfg))
        _, y_ref = ref_step(st_ref, xs)
    err = float(np.abs(y - np.asarray(y_ref)).max())
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    per = time_dispatch(compiled, st, xs[:K_FLAG])
    audio_s = S_FLAG * K_FLAG * H_FLAG * HOP / 48000.0
    say("flagship", streams=S_FLAG, chunk_samples=H_FLAG * HOP,
        chunks_per_dispatch=K_FLAG, dispatches=D_FLAG,
        hot_precision=_prec.hot_mode(),
        max_abs_err_vs_reference=err, tol=TOL,
        ms_per_dispatch=round(1e3 * per, 3), rtf=round(audio_s / per, 1))
    say("flagship", temp_bytes=mem.temp_size_in_bytes,
        argument_bytes=mem.argument_size_in_bytes,
        output_bytes=mem.output_size_in_bytes,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    check(err <= TOL, f"flagship max abs err {err} > {TOL}")


def phase_c_parity():
    import jax
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import ambi_bin
    from spatial_audio_framework_tpu.modules import sh
    from spatial_audio_framework_tpu.utils import geometry as geo

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "goldens", "c_goldens.npz"))
    cfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d",
                                 enable_rotation=True)
    wri = ambi_bin.design_ri(cfg)
    x = jnp.asarray(g["ambi_bin_enc_y"][:, None]
                    * g["ambi_bin_in_mono"][None, :])
    ypr = jnp.asarray(np.array([np.pi, 0.0, 0.0], np.float32))
    proc = jax.jit(lambda s, xx: ambi_bin.process_ri(cfg, wri, s, xx, ypr))
    st = ambi_bin.init_state_ri(cfg)
    outs = []
    for f in range(16):
        y, st = proc(st, x[:, f * 512:(f + 1) * 512])
        outs.append(np.asarray(y))
    err_ri = float(np.abs(np.concatenate(outs, -1) - g["ambi_bin_out"]).max())

    R = geo.yaw_pitch_roll2_rzyx(ypr[0], ypr[1], ypr[2])
    M_rot = sh.get_sh_rot_mtx_real(R.astype(jnp.float32), cfg.order)
    hi = jax.lax.Precision.HIGHEST
    w_rot = tuple(jnp.einsum("bes,st->bet", m, M_rot, precision=hi)
                  for m in wri)
    yb, _ = jax.jit(lambda s, xx: ambi_bin.process_ri_batched(
        cfg, w_rot, s, xx))(ambi_bin.init_state_batched(cfg, 1), x[None])
    err_b = float(np.abs(np.asarray(yb)[0] - g["ambi_bin_out"]).max())
    say("c_parity", golden="ambi_bin_out order4 yaw180",
        max_abs_err_process_ri=err_ri, max_abs_err_batched=err_b, tol=TOL)
    check(err_ri <= TOL and err_b <= TOL, "C parity above budget")


def phase_renderers(rng):
    import jax
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import (
        ambi_dec, ambi_drc, ambi_enc, ambi_roomsim, array2sh, beamformer,
        binauraliser, binauraliser_nf, conv_examples, decorrelator, dirass,
        panner, pitch_shifter, powermap, roombinauraliser, rotator, sldoa,
        spreader)
    from spatial_audio_framework_tpu.modules import hades
    from spatial_audio_framework_tpu.modules import sh as sh_mod
    from spatial_audio_framework_tpu.utils import presets as _presets

    S, T = 8, 16 * HOP
    runs = []

    def u(*shape):
        return jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))

    bcfg = binauraliser.BinauraliserConfig(n_sources=2, enable_rotation=True)
    bw = binauraliser.design_ri(bcfg)
    dirs = jnp.asarray(rng.uniform(-90, 90, (S, 2, 2)).astype(np.float32))
    ypr = jnp.zeros((S, 3), jnp.float32)
    runs.append(("binauraliser", lambda s, x: binauraliser.process_ri_batched(
        bcfg, bw, s, x, dirs, None, ypr)[0],
        binauraliser.init_state_batched(bcfg, S), u(S, 2, T)))

    azis = -180.0 + 30.0 * np.arange(12)
    gdirs = np.stack([azis, np.zeros(12)], -1)
    brirs = 0.05 * rng.standard_normal((2, 12, 2, 128)).astype(np.float32)
    brirs[:, :, :, 4] += 1.0
    rcfg, rw = roombinauraliser.design_ri(
        roombinauraliser.RoomBinauraliserConfig(
            n_sources=2, enable_hrir_diff_eq=False), brirs, gdirs, 48000)
    runs.append(("roombinauraliser",
                 lambda s, x: roombinauraliser.process_ri_batched(
                     rcfg, rw, s, x, ypr=ypr)[0],
                 roombinauraliser.init_state_batched(rcfg, S), u(S, 2, T)))

    ls = np.array([[30.0, 0], [-30, 0], [110, 0], [-110, 0], [0, 90]])
    dcfg = ambi_dec.AmbiDecConfig(master_order=1)
    dw = ambi_dec.design_ri(dcfg, ls)
    runs.append(("ambi_dec", lambda s, x: ambi_dec.process_ri_batched(
        dcfg, dw, s, x)[0], ambi_dec.init_state_batched(dcfg, S, 5),
        u(S, dcfg.nsh, T)))

    ncfg = binauraliser_nf.BinauraliserNFConfig(n_sources=2,
                                                enable_rotation=False)
    nw = binauraliser_nf.design_ri(ncfg)
    nd = jnp.asarray(rng.uniform(0.2, 1.5, (S, 2)).astype(np.float32))
    runs.append(("binauraliser_nf",
                 lambda s, x: binauraliser_nf.process_ri_batched(
                     ncfg, nw, s, x, dirs, nd)[0],
                 binauraliser_nf.init_state_batched(ncfg, S), u(S, 2, T)))

    pcfg = panner.PannerConfig(n_sources=2, n_loudspeakers=5)
    pw = panner.design(pcfg, ls)
    runs.append(("panner", lambda s, x: panner.process_ri_batched(
        pcfg, pw, s, x, dirs)[0], panner.init_state_batched(pcfg, S, 5),
        u(S, 2, T)))

    ccfg = ambi_drc.AmbiDrcConfig(order=1, theshold_db=-20.0)
    runs.append(("ambi_drc", lambda s, x: ambi_drc.process_ri_batched(
        ccfg, s, x)[0], ambi_drc.init_state_batched(ccfg, S),
        u(S, ccfg.nsh, T)))

    ecfg = decorrelator.DecorrelatorConfig(n_channels=2)
    ed = decorrelator.design(ecfg)
    runs.append(("decorrelator", lambda s, x: decorrelator.process_ri_batched(
        ecfg, ed, s, x)[0], decorrelator.init_state_batched(ecfg, ed, S),
        u(S, 2, T)))

    em32 = np.degrees(_presets.mic_preset("eigenmike32"))
    acfg = array2sh.Array2SHConfig(order=4)
    aw = array2sh.design_ri(acfg, em32)
    runs.append(("array2sh", lambda s, x: array2sh.process_ri_batched(
        acfg, aw, s, x)[0], array2sh.init_state_batched(acfg, S, 32),
        u(S, 32, T)))

    tv = conv_examples.TVConvExample()
    tirs = 0.1 * rng.standard_normal((4, 2, 512)).astype(np.float32)
    tirs[:, :, 0] += 1.0
    tpos = rng.uniform(0, 5, (4, 3)).astype(np.float32)
    tconv, tH, tposd = tv.design_ri(tirs, tpos)
    runs.append(("tvconv", lambda s, x: tv.process_ri(
        tconv, tH, s, x, jnp.asarray(tpos[1]), tposd)[0],
        tv.init_state_ri(tconv), u(T)))

    Y3 = sh_mod.get_rsh(3, np.array([[40.0, 10.0]]))[:, 0:1]
    ax = jnp.asarray((Y3 * rng.uniform(-1, 1, (1, T))).astype(np.float32))
    pmc = powermap.PowermapConfig(master_order=3, mode=powermap.PM_MUSIC,
                                  norm="n3d")
    pmw = powermap.design(pmc)
    runs.append(("powermap", lambda s, x: powermap.analysis(
        pmc, pmw, s, x)[0], powermap.init_state(pmc, pmw), ax))
    slc = sldoa.SldoaConfig(master_order=3, norm="n3d")
    slw = sldoa.design(slc)
    runs.append(("sldoa", lambda s, x: 1e-9 * sldoa.analysis(
        slc, slw, s, x)[0].energy, sldoa.init_state(slc), ax))
    drc = dirass.DirassConfig(input_order=3, mode="upscale", norm="n3d")
    drw = dirass.design(drc)
    runs.append(("dirass", lambda s, x: dirass.analysis(drc, drw, s, x)[0],
                 dirass.init_state(drc, drw), ax))

    spc = spreader.SpreaderConfig(n_sources=1, mode=spreader.MODE_OM)
    spw = spreader.design(spc)
    spd = jnp.asarray(np.array([[60.0, 0.0]], np.float32))
    sps = jnp.asarray(np.array([90.0], np.float32))
    runs.append(("spreader", lambda s, x: spreader.process(
        spc, spw, s, x, spd, sps)[0], spreader.init_state(spc, spw),
        u(1, T)))

    psc = pitch_shifter.PitchShifterConfig(n_ch=1)
    psm = pitch_shifter.design(psc)
    runs.append(("pitch_shifter", lambda s, x: pitch_shifter.process(
        psc, s, x, jnp.float32(1.5), mats=psm)[0],
        pitch_shifter.init_state(psc), u(1, T)))

    hana = hades.HadesAnalysis()
    hpipe = hades.HadesPipeline(hana, hades.HadesSynthesis(
        hana, beam_option=hades.HADES_BEAMFORMER_BMVDR))
    runs.append(("hades", lambda s, x: hpipe.process(s, x)[0],
                 hpipe.init_state(), u(2, hana.blocksize)))

    qcfg = ambi_enc.AmbiEncConfig(order=3, n_sources=4)
    qout = ambi_enc.design(qcfg)
    qdirs = jnp.asarray(rng.uniform(-90, 90, (4, 2)).astype(np.float32))
    qx = u(4, qcfg.frame_size)
    qst = ambi_enc.process(qcfg, qout, ambi_enc.init_state(
        qcfg, np.asarray(qdirs)), qx, qdirs)[1]
    runs.append(("ambi_enc", lambda s, x: ambi_enc.process(
        qcfg, qout, s, x, qdirs)[0], qst, qx))

    bfc = beamformer.BeamformerConfig(order=3, n_beams=4)
    bW = beamformer.design(bfc, np.asarray(rng.uniform(-90, 90, (4, 2))))
    bfx = u(bfc.nsh, bfc.frame_size)
    bfst = beamformer.process(bfc, bW, beamformer.init_state(bfc), bfx)[1]
    runs.append(("beamformer", lambda s, x: beamformer.process(
        bfc, bW, s, x)[0], bfst, bfx))

    rtc = rotator.RotatorConfig(order=3)
    rtw = rotator.design(rtc)
    rypr = jnp.asarray(np.array([0.7, -0.2, 0.1], np.float32))
    rtx = u(rtc.nsh, rtc.frame_size)
    rtst = rotator.process(rtc, rtw, rotator.init_state(rtc), rtx, rypr)[1]
    runs.append(("rotator", lambda s, x: rotator.process(
        rtc, rtw, s, x, rypr)[0], rtst, rtx))

    rsc = ambi_roomsim.AmbiRoomSimConfig(n_sources=2, n_receivers=1,
                                         sh_order=2, refl_order=2)
    rsw = ambi_roomsim.design_ri(
        rsc, np.array([[2.0, 3.0, 1.5], [4.0, 2.0, 1.7]]),
        np.array([[3.0, 2.5, 1.6]]))
    runs.append(("ambi_roomsim", lambda s, x: ambi_roomsim.process_ri(
        rsc, rsw, s, x)[0], ambi_roomsim.init_state_ri(rsc, rsw), u(2, T)))

    mce = conv_examples.MatrixConvExample()
    mconv, mH = mce.design_ri(
        0.1 * rng.standard_normal((2, 4, 1024)).astype(np.float32))
    mx = u(4, T)
    runs.append(("matrixconv", lambda s, x: mce.process_ri(
        mconv, mH, s, x)[0], mce.init_state_ri(mconv), mx))
    mue = conv_examples.MultiConvExample()
    uconv, uH = mue.design_ri(
        0.1 * rng.standard_normal((4, 1024)).astype(np.float32))
    runs.append(("multiconv", lambda s, x: mue.process_ri(
        uconv, uH, s, x)[0], mue.init_state_ri(uconv), mx))

    bad = []
    for name, fn, st, x in runs:
        y = np.asarray(jax.jit(fn)(st, x))
        peak = float(np.abs(y).max())
        good = bool(np.isfinite(y).all() and peak < 100.0)
        say("renderers", model=name, shape=y.shape, peak=peak,
            result="ok" if good else "BAD")
        if not good:
            bad.append(name)
    check(not bad, f"renderers with non-finite or unbounded output: {bad}")


def phase_four(rng):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spatial_audio_framework_tpu.models import ambi_bin
    from spatial_audio_framework_tpu.parallel import mesh as pmesh

    n = 4
    check(jax.device_count() >= n,
          f"--four needs {n} devices, JAX has {jax.device_count()}")
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    wri = ambi_bin.design_ri(cfg)
    S = S_FLAG * n
    xs = chunked_input(rng, S, cfg.nsh, H_FLAG, K_FLAG)
    mesh = pmesh.make_mesh(n, tp=1)
    spec = P(("dp", "tp"))

    def render(st, x):
        return ambi_bin.process_ri_batched(cfg, wri, st, x)

    sharded = shard_map(render, mesh=mesh, in_specs=(spec, spec),
                        out_specs=spec, check_vma=False)
    st = jax.device_put(ambi_bin.init_state_batched(cfg, S),
                        NamedSharding(mesh, spec))
    xsh = jax.device_put(xs, NamedSharding(mesh, P(None, ("dp", "tp"))))
    step = jax.jit(scan_render(sharded))
    _, y4 = step(st, xsh)
    jax.block_until_ready(y4)
    per4 = time_dispatch(step, st, xsh)
    shard_devs = sorted(s.device.id for s in y4.addressable_shards)
    check(len(set(shard_devs)) == n,
          f"output shards do not span {n} devices: {shard_devs}")
    for s in y4.addressable_shards:
        check(s.data.devices() == {s.device},
              "a shard's data is not on its own device")

    one = jax.jit(scan_render(render))
    st1 = ambi_bin.init_state_batched(cfg, S)
    _, y1 = one(st1, xs)
    per1 = time_dispatch(one, st1, xs)
    err = float(np.abs(np.asarray(y4) - np.asarray(y1)).max())
    audio_s = S * K_FLAG * H_FLAG * HOP / 48000.0
    say("four", devices=n, streams=S, shard_devices=shard_devs,
        max_abs_err_vs_one_card=err, tol=TOL,
        ms_per_dispatch_four=round(1e3 * per4, 3),
        ms_per_dispatch_one=round(1e3 * per1, 3),
        rtf_four=round(audio_s / per4, 1), rtf_one=round(audio_s / per1, 1))
    check(err <= TOL, f"four-card render differs from one card: {err}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card data-parallel render and its "
                         "one-card comparison")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    from bench import compile_cache_dir
    import spatial_audio_framework_tpu  # noqa: F401  (fails outside a checkout)

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    dev = jax.devices()[0]
    say("device", platform=dev.platform, kind=f'"{dev.device_kind}"',
        count=jax.device_count())
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = gpu_name_and_power_limit()
    print(card, flush=True)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.four:
        phase_four(rng)
    else:
        phase_flagship(rng)
        phase_c_parity()
        phase_renderers(rng)
    say("done", seconds=round(time.perf_counter() - t0, 1))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
