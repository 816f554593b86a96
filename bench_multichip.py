"""Multi-device scale-out benchmark: the flagship render sharded over a
('dp', 'tp') jax.sharding.Mesh.

Runs on the devices JAX finds and fails when there are fewer than N.  On
virtual CPU devices (JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=N) its correctness
assertions and compiled collective schedule are meaningful, its times are
not: every virtual device shares one host.

What it measures (order-3 MagLS ambi_bin at production shapes — 133 hybrid
bands, hop 128, 64-hop chunks):

1. dp weak scaling: S_PER streams on 1 device vs S_PER×N streams sharded
   'dp' over N devices via shard_map (the production RI fast path).  Ideal
   weak scaling keeps the step time flat; efficiency = t1 / tN.
2. tp=2 tensor parallelism at production shapes: the per-band decode
   contraction out[b,e,h] = Σ_s M[b,e,s]·spec[b,s,h] with the SH axis s
   sharded over 'tp' — XLA inserts the psum over 'tp' (GSPMD).  Output is
   asserted ≤1e-5 against the unsharded render.

Prints one JSON line.  Env: SAF_MULTICHIP_DEVICES (default 8).
"""
import json
import os
import re
import time

import numpy as np


def main():
    N = int(os.environ.get("SAF_MULTICHIP_DEVICES", "8"))

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spatial_audio_framework_tpu.models import ambi_bin
    from spatial_audio_framework_tpu.parallel import mesh as pmesh

    if jax.device_count() < N:
        raise RuntimeError(
            f"bench_multichip needs {N} devices (SAF_MULTICHIP_DEVICES), "
            f"JAX has {jax.device_count()}")

    FS = 48000.0
    HOP = 128
    T = 64 * HOP                 # one ~171 ms chunk per dispatch
    # streams per device (weak-scaling unit); SAF_MULTICHIP_S_PER=32 with
    # 8 devices = the 256-stream production scale
    S_PER = int(os.environ.get("SAF_MULTICHIP_S_PER", "8"))
    CHAIN = 8
    REPS = 3

    cfg = ambi_bin.AmbiBinConfig(order=3, fs=FS, method="magls")
    wri = ambi_bin.design_ri(cfg)
    rng = np.random.default_rng(0)

    def timed_chain(step, state, x):
        e, state = step(state, x)
        jax.block_until_ready(e)
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            for _ in range(CHAIN):
                e, state = step(state, x)
            jax.block_until_ready((e, state))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) / CHAIN

    def render(st, x):
        y, st = ambi_bin.process_ri_batched(cfg, wri, st, x)
        return jnp.sum(y * y), st

    _DTYPE_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "s32": 4,
                    "u32": 4, "s8": 1, "u8": 1, "pred": 1, "c64": 8}

    def collective_inventory(compiled) -> dict:
        """Count collective ops + their output bytes in a compiled HLO.

        Deterministic for a given mesh/sharding: the partitioner emits the
        same collective schedule on virtual CPU devices as on real cards.
        """
        hlo = compiled.as_text()
        inv = {}
        total = 0
        # matches synchronous collectives AND the async '-done' halves
        # (all-gather-start/-done pairs with tuple-typed starts: bytes are
        # taken from the done/sync op's result, which is the plain
        # transferred shape; '-start' ops are intentionally NOT matched to
        # avoid double counting)
        line_re = re.compile(
            r"= (\([^)]*\)|[a-z0-9]+\[[\d,]*\]\S*) "
            r"(all-reduce|all-gather|reduce-scatter|collective-permute"
            r"|all-to-all)(-done)?\(")
        shape_re = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
        for m in line_re.finditer(hlo):
            op = m.group(2)
            b = 0
            for dt, dims in shape_re.findall(m.group(1)):
                n = 1
                for d in dims.split(","):
                    if d:
                        n *= int(d)
                b += n * _DTYPE_BYTES.get(dt, 4)
            inv[op] = inv.get(op, 0) + 1
            inv[f"{op}_bytes"] = inv.get(f"{op}_bytes", 0) + b
            total += b
        inv["total_bytes_per_step"] = total
        return inv

    # one input set: the first S_PER streams double as the 1-device baseline
    S = S_PER * N
    x_all = rng.uniform(-1, 1, (S, cfg.nsh, T)).astype(np.float32)

    # ---- 1 device, S_PER streams (weak-scaling baseline) -------------------
    dev0 = jax.devices()[0]
    x1 = jax.device_put(jnp.asarray(x_all[:S_PER]), dev0)
    st1 = jax.tree.map(lambda a: jax.device_put(a, dev0),
                       ambi_bin.init_state_batched(cfg, S_PER))
    t_1dev = timed_chain(jax.jit(render), st1, x1)

    # ---- N devices, S_PER×N streams on 'dp' (production shard_map path) ----
    mesh = pmesh.make_mesh(N, tp=1)
    x = jax.device_put(jnp.asarray(x_all),
                       NamedSharding(mesh, P(("dp", "tp"), None, None)))
    st = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(
            mesh, P(("dp", "tp"), *([None] * (a.ndim - 1))))),
        ambi_bin.init_state_batched(cfg, S))

    def render_y(st, x):
        return ambi_bin.process_ri_batched(cfg, wri, st, x)

    sharded = shard_map(render_y, mesh=mesh,
                        in_specs=(P(("dp", "tp")), P(("dp", "tp"))),
                        out_specs=P(("dp", "tp")), check_vma=False)

    def dp_step(st, x):
        y, st = sharded(st, x)
        return jnp.sum(y * y), st

    coll_dp = collective_inventory(jax.jit(sharded).lower(st, x).compile())

    # correctness: sharded == single-device render of the same first streams
    y_dp, _ = jax.jit(sharded)(st, x)
    y_ref, _ = jax.jit(render_y)(ambi_bin.init_state_batched(cfg, S_PER),
                                 x1)
    err_dp = float(jnp.max(jnp.abs(np.asarray(y_dp)[:S_PER]
                                   - np.asarray(y_ref))))
    t_ndev = timed_chain(jax.jit(dp_step), st, x)
    weak_eff = t_1dev / t_ndev

    # ---- tp=2 at production shapes (GSPMD-partitioned decode) --------------
    tp_res = {}
    if N % 2 == 0 and N >= 4:
        mesh2 = pmesh.make_mesh(N, tp=2)
        S2 = S_PER * (N // 2)
        x2 = jnp.asarray(rng.uniform(
            -1, 1, (S2, cfg.nsh, T)).astype(np.float32))
        st2 = ambi_bin.init_state_batched(cfg, S2)

        def spec_state(a):
            if a.ndim >= 2 and a.shape[1] == cfg.nsh:
                return NamedSharding(mesh2, P("dp", "tp",
                                              *([None] * (a.ndim - 2))))
            return NamedSharding(mesh2, P("dp", *([None] * (a.ndim - 1))))

        x2s = jax.device_put(x2, NamedSharding(mesh2, P("dp", "tp", None)))
        st2s = jax.tree.map(jax.device_put, st2,
                            jax.tree.map(spec_state, st2))
        wri_s = jax.tree.map(lambda a: jax.device_put(
            a, NamedSharding(mesh2, P(None, None, "tp"))), wri)

        def render_tp(w, st, x):
            y, st = ambi_bin.process_ri_batched(cfg, w, st, x)
            return y, st

        coll_tp = collective_inventory(
            jax.jit(render_tp).lower(wri_s, st2s, x2s).compile())
        tp_audio = S2 * T / FS
        y_tp, st2o = jax.jit(render_tp)(wri_s, st2s, x2s)
        y_ref2, _ = jax.jit(lambda st, x: ambi_bin.process_ri_batched(
            cfg, wri, st, x))(st2, x2)
        err_tp = float(jnp.max(jnp.abs(np.asarray(y_tp)
                                       - np.asarray(y_ref2))))

        def tp_step(st, x):
            y, st = render_tp(wri_s, st, x)
            return jnp.sum(y * y), st

        t_tp = timed_chain(jax.jit(tp_step), st2s, x2s)
        tp_res = {
            "tp2_step_s": round(t_tp, 4),
            "tp2_streams": S2,
            "tp2_rtf": round(S2 * T / FS / t_tp, 1),
            "tp2_max_err_vs_unsharded": err_tp,
            "collectives_tp2": coll_tp,
            "tp2_collective_bytes_per_audio_sec": round(
                coll_tp["total_bytes_per_step"] / tp_audio, 1),
        }
        assert err_tp <= 1e-5, err_tp

    assert err_dp <= 1e-5, err_dp
    audio_1 = S_PER * T / FS
    audio_n = S * T / FS
    # HEADLINE: the compiled collective inventory (bytes that must cross
    # the interconnect per rendered audio-second, tp=2 decode at
    # production scale), which does not depend on the device kind.
    headline = tp_res.get("tp2_collective_bytes_per_audio_sec",
                          round(coll_dp["total_bytes_per_step"]
                                / audio_n, 1))
    print(json.dumps({
        "metric": "ambi_bin_multichip_collective_bytes_per_audio_sec",
        "value": headline,
        "unit": ("interconnect bytes per rendered audio-second "
                 "(tp=2 GSPMD decode; dp render needs "
                 f"{coll_dp['total_bytes_per_step']} B/step)"),
        "extra": {
            "devices": N,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "streams_per_device": S_PER,
            "collectives_dp": coll_dp,
            "weak_scaling_efficiency": round(weak_eff, 3),
            "t_1dev_step_s": round(t_1dev, 4),
            "t_Ndev_step_s": round(t_ndev, 4),
            "rtf_1dev": round(audio_1 / t_1dev, 1),
            "rtf_Ndev_total": round(audio_n / t_ndev, 1),
            "dp_max_err_vs_1dev": err_dp,
            **tp_res,
        },
    }))


if __name__ == "__main__":
    main()
