"""Benchmark: 64 concurrent order-3 MagLS ambi_bin streams, real-time factor.

Prints JSON lines {"metric", "value", "unit", "vs_baseline", "extra"} where
value is audio-seconds rendered per wall-second per device (RTF) and
vs_baseline is value / 100 (the reference publishes no numbers).

Emission protocol (a reader parses the LAST line of stdout — so the last
line printed is ALWAYS a compact ≤1500-byte summary; every emit prints the
full enriched line first, then the compact line, and optionally rewrites
the full record to ``$SAF_BENCH_ARTIFACT`` atomically):
* the flagship config is measured FIRST and its JSON line printed+flushed
  immediately; every subsequent config completion re-prints the enriched
  JSON, so the last line always carries everything measured so far;
* every operation runs under a per-op watchdog deadline (a daemon thread);
  on expiry the partial JSON is printed and the process force-exits 0;
* a wall-clock budget (env SAF_BENCH_BUDGET_S, default 780 s) bounds the
  whole run: configs that would not fit are skipped and listed in
  extra.skipped_configs;
* SIGTERM/SIGINT dump the partial JSON before exiting.
* SAF_BENCH_SMOKE=1 shrinks every config to seconds-scale (CI runs this on
  CPU to gate the emission protocol itself — tests/test_bench_harness.py).
  A CPU run reports no device metric: the roofline fields read
  "not measured".

Measurement notes:
* every timing ends in ``jax.block_until_ready``; a config's time per
  dispatch is the median over repetitions of a chain of state-carrying
  dispatches divided by the chain length.
* throughput: K chunks rendered per dispatch via device-side lax.scan with
  distinct (rolled) inputs pregenerated on device; the wall time therefore
  includes reading every input sample from device memory.
* accuracy: one block is re-rendered on CPU (float32, same pipeline) and the
  max abs deviation of the device output is reported, plus the max abs
  error vs the COMPILED C REFERENCE golden (budget: 1e-4).
* compile cache: ``JAX_COMPILATION_CACHE_DIR`` when set, else
  ``.jax_cache/`` in the checkout (:func:`compile_cache_dir`).

Roofline accounting:
* FLOPs and device-memory bytes per dispatch are read from XLA's own cost
  analysis of the compiled per-chunk body (``jit(body).lower(...).compile()
  .cost_analysis()``) and multiplied by the explicit trip counts this file
  controls (chunks per dispatch, frames per chunk).  XLA counts a while-loop
  body ONCE, so bodies are probed at the innermost our-own-scan level.
* Peaks come from :data:`PEAKS`, keyed by ``device_kind`` (an unknown
  device is an error), beside MEASURED-ACHIEVABLE rates calibrated at bench
  time: a large chained matmul (bf16 and f32 at the hot precision) and a
  large chained streaming triad.  Reported under extra.calibration;
  per-config fields ``mfu_pct_nominal``, ``mfu_pct_achievable``,
  ``hbm_pct_measured``.
* XLA's "bytes accessed" is a PRE-FUSION upper bound on true device-memory
  traffic; byte-derived fields are labelled ``_xla_est``.  For the
  FLAGSHIP the bytes are additionally HAND-COUNTED from the static shapes
  (input + output + 2x filterbank state + weights per chunk — the
  algorithmic floor), and its bound verdict uses the floor bytes against
  the MEASURED bandwidth.
* per-config verdict: utilization = max(achievable-MFU, min(bandwidth
  fraction vs measured peak, 1)); >=50 % => "compute"- or "bandwidth"-bound
  (whichever limb binds); otherwise "dispatch/overhead".
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np

# Published peaks per device kind (dense, no sparsity), keyed by JAX's
# ``device_kind``.  Source: NVIDIA H100 SXM data sheet, at the 700 W power
# limit; a card set below it cannot hold its top clock under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tflops_bf16": 989.0, "tflops_tf32": 495.0,
                              "tflops_f32": 67.0, "hbm_gbps": 3350.0},
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; a device missing from
    :data:`PEAKS` is an error, not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to bench.PEAKS") from None


def compile_cache_dir(environ=None) -> str:
    """The persistent compile-cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache`` beside this file (a fixed path, so the
    cache key stays stable across runs)."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".jax_cache")


# ---------------------------------------------------------------------------
# Harness skeleton (importable without JAX; CI-gated by
# tests/test_bench_harness.py so print-only-at-the-end can never come back)
# ---------------------------------------------------------------------------
class BenchReport:
    """Incrementally-emitted benchmark result.

    Holds the single result dict; ``emit()`` prints the WHOLE current state
    as one JSON line, then a COMPACT (≤ :data:`COMPACT_MAX_BYTES` bytes)
    summary line, and flushes.  A reader that keeps only the tail of
    stdout parses the LAST line from it, and an enriched line runs to
    several KB, so the last line printed must always be the compact one: metric/value/unit/vs_baseline plus the handful of headline extras
    (flagship ms/dispatch, C-parity error, latency, config/error counts)
    and a pointer to the full artifact.  Set ``artifact_path`` (env
    ``SAF_BENCH_ARTIFACT``) to also atomically rewrite the FULL enriched
    record to a file on every emit.  Thread-safe: the watchdog thread
    emits from ``on_expire`` while the main thread may be blocked.
    """

    COMPACT_MAX_BYTES = 1500
    # extra fields copied into the compact line when present, in
    # keep-priority order (later ones are dropped first if the cap binds)
    _COMPACT_KEYS = (
        "ms_per_dispatch_flagship",
        "max_abs_err_vs_c_reference",
        "p50_device_block_latency_ms_85ms_block",
        "p50_block_latency_ms_85ms_block",
        "max_abs_err_vs_cpu_f32",
        "matmul_precision",
    )

    def __init__(self, metric: str, unit: str, baseline_divisor: float = 100.0,
                 stream=None, artifact_path: str = None):
        self._stream = stream if stream is not None else sys.stdout
        self._artifact_path = artifact_path
        self._lock = threading.Lock()
        self.baseline_divisor = baseline_divisor
        self.result = {
            "metric": metric,
            "value": None,
            "unit": unit,
            "vs_baseline": None,
            "extra": {
                "status": "starting",
                "config_rtfs": {},
                "config_errors": {},
                "skipped_configs": [],
            },
        }

    def set_value(self, value: float) -> None:
        with self._lock:
            self.result["value"] = round(float(value), 2)
            self.result["vs_baseline"] = round(
                float(value) / self.baseline_divisor, 3)

    def extra(self, **kv) -> None:
        with self._lock:
            self.result["extra"].update(kv)

    def config(self, name: str, entry: dict) -> None:
        with self._lock:
            self.result["extra"]["config_rtfs"][name] = entry

    def error(self, name: str, msg: str) -> None:
        with self._lock:
            self.result["extra"]["config_errors"][name] = msg

    def skipped(self, name: str) -> None:
        with self._lock:
            self.result["extra"]["skipped_configs"].append(name)

    def compact_line(self) -> str:
        """The ≤1500-byte driver-tail-safe summary line (see class doc).

        Hard-capped by construction: optional fields are dropped (reverse
        keep-priority) and the status truncated until the encoded line
        fits — CI asserts this for fully-populated reports
        (tests/test_bench_harness.py::test_compact_line_stays_under_cap).
        """
        with self._lock:
            return self._compact_line_locked()

    def _compact_line_locked(self) -> str:
        ex = self.result["extra"]
        extra = {"compact": True,
                 "status": str(ex.get("status", ""))[:180]}
        if self._artifact_path:
            # point only at an artifact THIS run actually writes
            extra["artifact"] = os.path.basename(self._artifact_path)
        for k in self._COMPACT_KEYS:
            if k in ex:
                extra[k] = ex[k]
        extra["n_configs"] = len(ex.get("config_rtfs", {}))
        extra["n_errors"] = len(ex.get("config_errors", {}))
        extra["n_skipped"] = len(ex.get("skipped_configs", []))
        if ex.get("error"):
            extra["error"] = str(ex["error"])[:200]
        rec = {"metric": self.result["metric"], "value": self.result["value"],
               "unit": self.result["unit"],
               "vs_baseline": self.result["vs_baseline"], "extra": extra}
        line = json.dumps(rec)
        droppable = [k for k in extra if k not in ("compact", "status")]
        while len(line.encode()) > self.COMPACT_MAX_BYTES and droppable:
            extra.pop(droppable.pop())
            line = json.dumps(rec)
        if len(line.encode()) > self.COMPACT_MAX_BYTES:
            extra["status"] = extra["status"][:40]
            line = json.dumps(rec)
        return line

    def emit(self, status: str = None) -> None:
        with self._lock:
            if status is not None:
                self.result["extra"]["status"] = status
            full = json.dumps(self.result)
            # full enriched line first, compact line LAST — whatever point
            # the stream is truncated or the process dies at, the last
            # complete line is parseable and carries the headline value
            print(full, file=self._stream, flush=True)
            print(self._compact_line_locked(), file=self._stream, flush=True)
        # the artifact file write happens OUTSIDE the lock: a wedged
        # filesystem must not deadlock the watchdog's on_expire emit (the
        # whole harness exists to never go rc=124-silent again)
        if self._artifact_path:
            try:
                tmp = self._artifact_path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(full + "\n")
                os.replace(tmp, self._artifact_path)
            except OSError:
                pass  # artifact write must never kill the report


def install_signal_handlers(report: BenchReport) -> None:
    """SIGTERM/SIGINT: dump the partial JSON, exit 0 (a diagnosed partial is
    a successful report)."""
    def handler(signum, frame):
        report.emit(status=f"terminated by signal {signum}; partial results")
        os._exit(0)
    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)


# ---------------------------------------------------------------------------
# Benchmark proper
# ---------------------------------------------------------------------------
def main():
    SMOKE = os.environ.get("SAF_BENCH_SMOKE", "") not in ("", "0")
    budget_s = float(os.environ.get("SAF_BENCH_BUDGET_S",
                                    "300" if SMOKE else "780"))

    report = BenchReport("ambi_bin_order3_magls_64streams_rtf",
                         "audio_sec/sec/device",
                         artifact_path=os.environ.get("SAF_BENCH_ARTIFACT")
                         or None)
    install_signal_handlers(report)

    from spatial_audio_framework_tpu.runtime.watchdog import Watchdog

    watchdog = Watchdog(
        on_expire=lambda reason: report.emit(status=f"watchdog: {reason}"),
        budget_s=budget_s)

    import jax
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    dev = jax.devices()[0]
    on_cpu = dev.platform == "cpu"
    peaks = None if on_cpu else device_peaks(dev.device_kind)
    report.extra(device={"platform": dev.platform, "kind": dev.device_kind,
                         "count": jax.device_count()})
    report.emit(status="device ok")

    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import ambi_bin
    from spatial_audio_framework_tpu.ops import precision as _prec

    FS = 48000.0
    N_STREAMS = 4 if SMOKE else 64
    ORDER = 3
    HOP = 128
    K = 2 if SMOKE else 8     # chunks per dispatch
    HOPS_CHUNK = 8 if SMOKE else 64   # hops per chunk (64 -> 8192 samples)
    NB = 2 if SMOKE else 32   # instances for the batched "_Nx" configs
    Tc = HOPS_CHUNK * HOP

    def guarded(name, timeout_s, fn, min_required_s=45.0):
        """Run fn under the per-op watchdog; returns fn() or None.

        Skips (recording the skip) when the remaining wall-clock budget
        could not fit the op; errors are recorded in config_errors instead
        of propagating, and the enriched JSON is re-emitted either way.
        """
        remaining = watchdog.budget_remaining_s()
        if remaining < min_required_s:
            report.skipped(name)
            report.emit(status=f"skipped {name}: budget exhausted")
            return None
        watchdog.begin(name, min(timeout_s, max(30.0, remaining - 10.0)))
        try:
            return fn()
        except Exception as e:
            report.error(name, repr(e))
            return None
        finally:
            watchdog.end()
            report.emit(status=f"after {name}")

    # ---- cost probing + roofline ------------------------------------------
    def probe_cost(body, *args, trips=1):
        """(flops, bytes) per dispatch: XLA cost analysis of the compiled
        body x the explicit trip count (see module docstring)."""
        try:
            d = jax.jit(body).lower(*args).compile().cost_analysis()
            d = d[0] if isinstance(d, (list, tuple)) else d
            return (trips * float(d.get("flops", 0.0)),
                    trips * float(d.get("bytes accessed", 0.0)))
        except Exception:
            return (0.0, 0.0)

    def probe_mem(body, *args):
        """Compiled-executable memory footprint (for batching anomalies)."""
        try:
            m = jax.jit(body).lower(*args).compile().memory_analysis()
            return {
                "temp_mb": round(m.temp_size_in_bytes / 2**20, 1),
                "args_mb": round(m.argument_size_in_bytes / 2**20, 1),
                "output_mb": round(m.output_size_in_bytes / 2**20, 1),
            }
        except Exception:
            return {}

    calibration = {}  # filled by calibrate(); measured-achievable peaks

    def tree_bytes_list(ts):
        return int(sum(tree_bytes(t) for t in ts))

    def algo_floor(xs, state, weights=(), out_bytes=0, trips=1,
                   w_trips=None):
        """Hand-counted algorithmic floor bytes per dispatch: every input
        sample read once + the application-facing outputs (rendered
        audio / maps — ``out_bytes``)
        written once + carried state read+written once per chunk + design
        weights read once per chunk.  A floor, not an estimate: unlike
        XLA's pre-fusion byte count it cannot exceed physical bandwidth,
        so floor-based fractions are real verdicts."""
        return (tree_bytes(xs) + int(out_bytes)
                + 2 * trips * tree_bytes(state)
                + (trips if w_trips is None else w_trips)
                * tree_bytes_list(weights))

    def roofline(cost, dt_per_dispatch, audio_sec, floor_bytes=None):
        """MFU/roofline verdict for one config (see module docstring).

        ``bytes accessed`` from XLA cost analysis is a PRE-FUSION upper
        bound on device-memory traffic (it sums every op's operand+output
        bytes, so re-reads that stay on chip inside a fusion are
        double-counted).  The byte-derived fields are therefore labelled
        ``_xla_est``.  When ``floor_bytes`` (hand-counted algorithmic bytes
        per dispatch) is given, the bandwidth limb uses it instead, against
        the MEASURED achievable bandwidth; utilization fractions are
        reported against both nominal and measured-achievable peaks, and
        the bound verdict uses the achievable ones.  <50 % of every
        achievable ceiling => dispatch/overhead-bound.
        """
        flops, byts = cost
        if peaks is None:
            return {"roofline": "not measured"}
        if not dt_per_dispatch or (not flops and not floor_bytes):
            return {}
        peak_tf = (peaks["tflops_f32"] if _prec.hot_mode() == "highest"
                   else peaks["tflops_tf32"])
        peak_gb = peaks["hbm_gbps"]
        tf = flops / dt_per_dispatch / 1e12
        gb_xla = byts / dt_per_dispatch / 1e9
        mfu_nom = tf / peak_tf
        out = {}
        if flops:  # Pallas-path configs report 0 flops: bandwidth-only
            out.update({
                "gflops_per_audio_sec": round(flops / audio_sec / 1e9, 3),
                "achieved_tflops": round(tf, 4),
                "mfu_pct_nominal": round(100.0 * mfu_nom, 3),
                "hbm_gbps_xla_est": round(gb_xla, 2),
                "hbm_pct_xla_est": round(100.0 * gb_xla / peak_gb, 2),
                "intensity_flop_per_byte_min": round(
                    flops / max(byts, 1.0), 2),
            })
        # achievable limbs (calibrated on this slice at bench time)
        ach_tf = calibration.get("matmul_f32_hot_tflops")
        ach_gb = calibration.get("hbm_gbps")
        mfu_ach = tf / ach_tf if ach_tf else None
        if mfu_ach is not None:
            out["mfu_pct_achievable"] = round(100.0 * mfu_ach, 2)
        if floor_bytes:
            gb_floor = floor_bytes / dt_per_dispatch / 1e9
            out["bytes_algorithmic_floor"] = int(floor_bytes)
            out["hbm_gbps_floor"] = round(gb_floor, 2)
            out["intensity_flop_per_byte_floor"] = round(
                flops / floor_bytes, 2)
            bw_gb = gb_floor
        else:
            bw_gb = gb_xla
        if ach_gb:
            bw_frac = bw_gb / ach_gb
            out["hbm_pct_measured"] = round(100.0 * bw_frac, 2)
        else:
            bw_frac = bw_gb / peak_gb
        util = max(mfu_ach if mfu_ach is not None else mfu_nom,
                   min(bw_frac, 1.0))
        if util >= 0.5:
            bound = ("compute" if (mfu_ach or mfu_nom) >= min(bw_frac, 1.0)
                     else "bandwidth")
        else:
            bound = "dispatch/overhead"
        out["roofline_frac_pct"] = round(100.0 * util, 2)
        out["bound"] = bound
        if floor_bytes is None and bw_gb > (ach_gb or peak_gb):
            out["byte_est_exceeds_peak"] = True
        return out

    def time_per_dispatch(p, state, xs, chain=8, n_rep=None):
        """Seconds per dispatch of jitted p(state, xs) -> (energy, state):
        median over ``n_rep`` chains of ``chain`` state-carrying dispatches,
        each chain ended by block_until_ready."""
        if n_rep is None:
            n_rep = 2 if SMOKE else 5
        ts = []
        for _ in range(n_rep):
            t0 = time.perf_counter()
            for _ in range(chain):
                e, state = p(state, xs)
            jax.block_until_ready((e, state))
            ts.append((time.perf_counter() - t0) / chain)
        return float(np.median(ts))

    def timed_rtf(step, state, xs, audio_sec, cost=None, floor_bytes=None,
                  chain=8):
        """step(state, xs) -> (energy_scalar, state).  Returns {"rtf": ...,
        "ms_per_dispatch": ...} + roofline fields when ``cost`` (flops,
        bytes per dispatch) is given."""
        p = jax.jit(step)
        jax.block_until_ready(p(state, xs))     # compile + warm up
        per = time_per_dispatch(p, state, xs, chain=chain)
        out = {"rtf": round(audio_sec / per, 1),
               "ms_per_dispatch": round(1e3 * per, 3)}
        if cost is not None:
            out.update(roofline(cost, per, audio_sec,
                                floor_bytes=floor_bytes))
        return out

    def scan_chunks(body):
        def step(st, xs):
            st, e = jax.lax.scan(body, st, xs)
            return jnp.sum(e), st
        return step

    def roll_instances(x, n):
        """n decorrelated instance copies of chunked input x (instance
        axis inserted at position 1, after the chunk axis): instance i is
        x rolled by 13·(i+1) samples.  ONE definition so every _Nx config
        benches identically-correlated inputs."""
        return jax.jit(lambda a: jax.vmap(
            lambda i: jnp.roll(a, 13 * (i + 1), -1),
            out_axes=1)(jnp.arange(n)))(x)

    def batch_instances(body, state, xs, n=None):
        """n independent instances of a (state, chunk)->(state, e) body in
        ONE dispatch: vmap the body, stack the state, give each instance a
        distinct (rolled) copy of the input chunks."""
        n = NB if n is None else n
        bst = jax.tree_util.tree_map(lambda a: jnp.stack([a] * n), state)
        return jax.vmap(body), bst, roll_instances(xs, n)

    def tree_bytes(t):
        # non-array leaves (python ints in config-bearing weight trees)
        # carry no device bytes
        return int(sum(int(np.prod(l.shape)) * l.dtype.itemsize
                       for l in jax.tree_util.tree_leaves(t)
                       if hasattr(l, "dtype") and hasattr(l, "shape")))

    # ======================================================================
    # FLAGSHIP FIRST: measure, set value, emit immediately (round-3 lesson)
    # ======================================================================
    cfg = ambi_bin.AmbiBinConfig(order=ORDER, fs=FS, method="magls")
    wri = ambi_bin.design_ri(cfg)
    rng = np.random.default_rng(0)
    xc = jnp.asarray(rng.uniform(
        -1, 1, (N_STREAMS, cfg.nsh, Tc)).astype(np.float32))
    # K distinct input chunks, generated on device (no h2d in the timed loop)
    xs = jax.jit(lambda x: jax.vmap(
        lambda k: jnp.roll(x, k + 1, axis=-1))(jnp.arange(K)))(xc)
    audio_sec = N_STREAMS * K * Tc / FS

    def flagship_body(st, xk):
        y, st = ambi_bin.process_ri_batched(cfg, wri, st, xk)
        return st, jnp.sum(y * y)

    def run_flagship():
        step = jax.jit(scan_chunks(flagship_body))
        states = ambi_bin.init_state_batched(cfg, N_STREAMS)
        jax.block_until_ready(step(states, xs))  # compile + warm up
        per = time_per_dispatch(step, states, xs)
        report.set_value(audio_sec / per)
        report.extra(
            ms_per_dispatch_flagship=round(1e3 * per, 3),
            chunks_per_dispatch=K, chunk_samples=Tc, n_streams=N_STREAMS,
            matmul_precision=_prec.hot_mode(),
        )
        return per

    flag_per = guarded("flagship", 600.0, run_flagship)
    if flag_per is None:
        report.emit(status="flagship failed; continuing with sub-configs")

    # -- flagship roofline: XLA flops + HAND-COUNTED algorithmic bytes ------
    def run_flagship_roofline():
        def flag_body_einsum(st, xk):
            y, st = ambi_bin.process_ri_batched(cfg, wri, st, xk)
            return st, jnp.sum(y * y)
        st0 = ambi_bin.init_state_batched(cfg, N_STREAMS)
        flag_cost = probe_cost(flag_body_einsum, st0, xs[0], trips=K)
        # algorithmic floor per dispatch: every input sample read once,
        # every output sample written once, filterbank state read+written
        # once per chunk, weights read once per chunk
        in_b = xs.dtype.itemsize * int(np.prod(xs.shape))          # K chunks
        out_b = K * 4 * N_STREAMS * 2 * Tc                         # f32 out
        st_b = 2 * K * tree_bytes(st0)
        w_b = K * tree_bytes(wri)
        floor = in_b + out_b + st_b + w_b
        entry = roofline(flag_cost, flag_per, audio_sec, floor_bytes=floor)
        report.extra(flagship_roofline=entry)
    if flag_per:
        guarded("flagship_roofline", 240.0, run_flagship_roofline)

    # -- accuracy vs the COMPILED C REFERENCE (tests/goldens, on-chip) ------
    def run_accuracy_c():
        g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "goldens", "c_goldens.npz"))
        gcfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d",
                                      enable_rotation=True)
        gw = ambi_bin.design_ri(gcfg)
        gst = ambi_bin.init_state_ri(gcfg)
        gx = jnp.asarray(g["ambi_bin_enc_y"][:, None]
                         * g["ambi_bin_in_mono"][None, :])
        gypr = jnp.asarray(np.array([np.pi, 0.0, 0.0], np.float32))
        gproc = jax.jit(lambda w, s, xx: ambi_bin.process_ri(gcfg, w, s, xx,
                                                             gypr))
        outs = []
        for f in range(16):
            gy, gst = gproc(gw, gst, gx[:, f * 512:(f + 1) * 512])
            outs.append(np.asarray(gy))
        err = float(np.abs(np.concatenate(outs, -1)
                           - g["ambi_bin_out"]).max())
        report.extra(max_abs_err_vs_c_reference=err)
    if not SMOKE:
        guarded("accuracy_vs_c", 180.0, run_accuracy_c)

    # -- accuracy vs CPU reference (one 4-stream chunk, subprocess) ---------
    def run_accuracy_cpu():
        import subprocess
        import tempfile
        x_small = np.asarray(xc[:4])
        with tempfile.TemporaryDirectory() as td:
            np.save(os.path.join(td, "x.npy"), x_small)
            code = (
                "import numpy as np, jax\n"
                "jax.config.update('jax_platforms','cpu')\n"
                "import jax.numpy as jnp\n"
                "from spatial_audio_framework_tpu.models import ambi_bin\n"
                f"cfg = ambi_bin.AmbiBinConfig(order={ORDER}, fs={FS}, "
                "method='magls')\n"
                "wri = ambi_bin.design_ri(cfg)\n"
                "x = jnp.asarray(np.load(r'%s/x.npy'))\n"
                "st = ambi_bin.init_state_batched(cfg, 4)\n"
                "y, _ = ambi_bin.process_ri_batched(cfg, wri, st, x)\n"
                "np.save(r'%s/y.npy', np.asarray(y))\n" % (td, td))
            subprocess.run([sys.executable, "-c", code], check=True,
                           timeout=240, capture_output=True)
            y_cpu = np.load(os.path.join(td, "y.npy"))
        st4 = ambi_bin.init_state_batched(cfg, 4)
        y_dev, _ = jax.jit(lambda w, s, x: ambi_bin.process_ri_batched(
            cfg, w, s, x))(wri, st4, xc[:4])
        report.extra(max_abs_err_vs_cpu_f32=float(
            jnp.max(jnp.abs(y_dev - jnp.asarray(y_cpu)))))
    if not SMOKE:
        guarded("accuracy_vs_cpu", 300.0, run_accuracy_cpu)

    # -- calibration: measured-achievable rates on this device, right now --
    def run_calibration():
        # matmul ceiling: state-carrying chained square matmuls, f32 at the
        # hot precision (the process paths' mode) and bf16.  Results land
        # in a LOCAL dict and publish into the shared ``calibration`` only
        # once complete, so a mid-calibration failure never leaves later
        # rooflines quoting a basis that never reached the artifact.
        c = {}
        N = 2048 if SMOKE else 8192
        a32 = jnp.asarray(rng.standard_normal((N, N)).astype(np.float32)
                          / np.sqrt(N))

        def mk(mat, precision):
            def step(s, xs):
                s2 = jax.lax.dot(s, mat, precision=precision) * 0.5
                return jnp.sum(s2 * s2), s2
            return step

        flops = 2.0 * N * N * N
        p32 = jax.jit(mk(a32, _prec.HOT))
        jax.block_until_ready(p32(a32, None))
        per32 = time_per_dispatch(p32, a32, None, chain=4, n_rep=3)
        c["matmul_f32_hot_tflops"] = round(flops / per32 / 1e12, 2)

        a16 = a32.astype(jnp.bfloat16)
        p16 = jax.jit(mk(a16, jax.lax.Precision.DEFAULT))
        jax.block_until_ready(p16(a16, None))
        per16 = time_per_dispatch(p16, a16, None, chain=4, n_rep=3)
        c["matmul_bf16_tflops"] = round(flops / per16 / 1e12, 2)

        # device-memory ceiling: streaming triad s = s*c + x
        # (2 reads + 1 write per element per step)
        M = (1024, 4096) if SMOKE else (8192, 16384)
        xbig = jnp.asarray(rng.standard_normal(M).astype(np.float32))

        def triad(s, x):
            s2 = s * np.float32(0.999) + x
            return jnp.sum(s2[0, :8]), s2

        pt = jax.jit(triad)
        st = jnp.zeros(M, jnp.float32)
        jax.block_until_ready(pt(st, xbig))
        pert = time_per_dispatch(pt, st, xbig, chain=8, n_rep=3)
        bytes_per = 3.0 * 4 * M[0] * M[1]
        c["hbm_gbps"] = round(bytes_per / pert / 1e9, 1)
        c["matmul_dim"] = N
        c["triad_mb"] = round(bytes_per / 3 / 2**20, 1)
        calibration.update(c)
        report.extra(calibration=dict(calibration), roofline_peaks=peaks)
    if not SMOKE and peaks is not None:
        guarded("calibration", 300.0, run_calibration)
        # re-derive the flagship roofline against the measured peaks
        if flag_per and calibration:
            guarded("flagship_roofline_calibrated", 120.0,
                    run_flagship_roofline)

    # -- streaming latency: one 85 ms block per dispatch --------------------
    # p50_device_block_latency_ms: mean time per 1-block dispatch over a
    # chain; p50/p99_block_latency_ms: wall clock of one dispatch, from
    # enqueue to block_until_ready.
    def run_latency():
        T = 32 * HOP
        xb = jnp.asarray(rng.uniform(
            -1, 1, (N_STREAMS, cfg.nsh, T)).astype(np.float32))

        def one_block(st, x):
            y, st = ambi_bin.process_ri_batched(cfg, wri, st, x)
            return jnp.sum(y * y), st

        proc1 = jax.jit(one_block)
        st = ambi_bin.init_state_batched(cfg, N_STREAMS)
        jax.block_until_ready(proc1(st, xb))
        per = time_per_dispatch(proc1, st, xb, chain=32)
        report.extra(p50_device_block_latency_ms_85ms_block=round(
            1e3 * per, 3))
        lat = []
        for _ in range(3 if SMOKE else 20):
            t0 = time.perf_counter()
            e, st = proc1(st, xb)
            jax.block_until_ready((e, st))
            lat.append(time.perf_counter() - t0)
        report.extra(
            p50_block_latency_ms_85ms_block=round(
                1000.0 * float(np.median(lat)), 3),
            p99_block_latency_ms_85ms_block=round(
                1000.0 * float(np.percentile(lat, 99)), 3))
    guarded("p50_latency", 240.0, run_latency)

    # ======================================================================
    # Remaining configs: one timed RTF each.  Each runs under
    # its own watchdog window and re-emits the enriched JSON on completion.
    # ======================================================================

    # flagship at 4x the stream count
    def run_256streams():
        S2 = 4 * N_STREAMS
        x2 = jnp.asarray(rng.uniform(
            -1, 1, (S2, cfg.nsh, Tc)).astype(np.float32))
        xs2 = jax.jit(lambda x: jax.vmap(
            lambda k: jnp.roll(x, k + 1, -1))(jnp.arange(K)))(x2)

        def fbody2(st, xk):
            y, st = ambi_bin.process_ri_batched(cfg, wri, st, xk)
            return st, jnp.sum(y * y)

        st2 = ambi_bin.init_state_batched(cfg, S2)
        floor2 = algo_floor(xs2, st2, (wri,), out_bytes=4 * K * S2 * 2 * Tc,
                            trips=K)
        report.config(f"ambi_bin_o3_magls_{S2}streams", timed_rtf(
            scan_chunks(fbody2), st2, xs2, S2 * K * Tc / FS,
            cost=(0.0, 0.0), floor_bytes=floor2))
    guarded("ambi_bin_256streams", 420.0, run_256streams)

    # flagship at the reference's MAX SH order (7 -> 64 channels,
    # _common.h:50)
    def run_order7():
        o7cfg = ambi_bin.AmbiBinConfig(order=7, fs=FS, method="magls")
        o7w = ambi_bin.design_ri(o7cfg)
        x7 = jnp.asarray(rng.uniform(
            -1, 1, (N_STREAMS, o7cfg.nsh, Tc)).astype(np.float32))
        xs7 = jax.jit(lambda x: jax.vmap(
            lambda k: jnp.roll(x, k + 1, -1))(jnp.arange(K)))(x7)

        def f7body(st, xk):
            y, st = ambi_bin.process_ri_batched(o7cfg, o7w, st, xk)
            return st, jnp.sum(y * y)

        st7 = ambi_bin.init_state_batched(o7cfg, N_STREAMS)
        floor7 = algo_floor(xs7, st7, (o7w,),
                            out_bytes=4 * K * N_STREAMS * 2 * Tc, trips=K)
        report.config(f"ambi_bin_o7_magls_{N_STREAMS}streams", timed_rtf(
            scan_chunks(f7body), st7, xs7, N_STREAMS * K * Tc / FS,
            cost=(0.0, 0.0), floor_bytes=floor7))
    if not SMOKE:
        guarded("ambi_bin_o7", 420.0, run_order7)

    # binauraliser: HRTFs loaded from an actual SOFA file through the
    # pure-Python HDF5 reader ("binauraliser: SOFA HRTF
    # interpolation + time-varying partitioned convolution")
    def run_binauraliser_sofa():
        import tempfile
        from spatial_audio_framework_tpu.models import binauraliser as BIN
        from spatial_audio_framework_tpu.modules import hrir as HRIR
        from spatial_audio_framework_tpu.modules import sofa as SOFA

        hr, hr_dirs, hr_fs = HRIR.default_hrirs()
        sofa_path = os.path.join(tempfile.gettempdir(),
                                 "saf_bench_hrirs.sofa")
        src_pos = np.concatenate(
            [np.asarray(hr_dirs, np.float64),
             np.ones((hr_dirs.shape[0], 1))], axis=1)
        SOFA.sofa_save(sofa_path, np.asarray(hr, np.float64), float(hr_fs),
                       src_pos)
        c = SOFA.sofa_open(sofa_path, usecase=SOFA.USECASE_HRIR)
        assert c.data_ir.shape == hr.shape and c.n_receivers == 2

        bcfg = BIN.BinauraliserConfig(n_sources=4, enable_rotation=True)
        bw = BIN.design_ri(bcfg, hrirs=c.data_ir,
                           hrir_dirs_deg=c.source_dirs_deg(),
                           hrir_fs=int(c.data_sampling_rate))
        S2, K2 = N_STREAMS, 4
        xb2 = jnp.asarray(rng.uniform(
            -1, 1, (S2, 4, Tc)).astype(np.float32))
        dirs = jnp.asarray(rng.uniform(-180, 180, (S2, 4, 2)).astype(
            np.float32) * np.array([1.0, 0.45], np.float32))
        yprs = jnp.asarray(rng.uniform(-1, 1, (S2, 3)).astype(np.float32))
        xs2 = jax.jit(lambda x: jax.vmap(
            lambda k: jnp.roll(x, k + 1, axis=-1))(jnp.arange(K2)))(xb2)

        def bbody(st, xk):
            y, st = BIN.process_ri_batched(bcfg, bw, st, xk, dirs,
                                           None, yprs)
            return st, jnp.sum(y * y)

        bst0 = BIN.init_state_batched(bcfg, S2)
        bcost = probe_cost(bbody, bst0, xs2[0], trips=K2)
        bfloor = algo_floor((xs2, dirs, yprs), bst0, (bw,),
                            out_bytes=4 * K2 * S2 * 2 * Tc, trips=K2)
        entry = timed_rtf(scan_chunks(bbody), bst0, xs2,
                           S2 * K2 * Tc / FS, chain=4,
                           cost=bcost, floor_bytes=bfloor)
        entry["hrtf_design_source"] = (
            "sofa_open('%s'): %d dirs @ %g Hz via utils/hdf5" % (
                os.path.basename(sofa_path), c.n_sources,
                c.data_sampling_rate))
        report.config(f"binauraliser_sofa_{S2}streams_4src", entry)
        report.extra(binauraliser_sofa_rtf=entry["rtf"])
    if not SMOKE:
        guarded("binauraliser_sofa", 420.0, run_binauraliser_sofa)

    # hades: fused analysis+synthesis pipeline (binaural, BMVDR + CM).
    # Headline = ONE instance, 64 blocks per dispatch (long chunks amortise
    # per-op launch cost); the NB-instance configuration is kept as _Nx.
    def run_hades():
        from spatial_audio_framework_tpu.modules import hades as HDS
        hana = HDS.HadesAnalysis()
        hsyn = HDS.HadesSynthesis(hana,
                                  beam_option=HDS.HADES_BEAMFORMER_BMVDR)
        hpipe = HDS.HadesPipeline(hana, hsyn)
        heq, hbal = hpipe._controls()
        NBH = 64
        hx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(NBH)))(jnp.asarray(rng.uniform(
                -1, 1, (hana.n_mics, hana.blocksize)).astype(np.float32)))

        def hstep(st, xs):
            st, ys = hpipe._chunk_fn(st, xs, heq, hbal)
            return jnp.sum(ys * ys), st

        hst0 = hpipe.init_state()
        hcost = probe_cost(hstep, hst0, hx, trips=1)
        hfloor = algo_floor(hx, hst0,
                            out_bytes=4 * 2 * NBH * hana.blocksize,
                            trips=NBH)
        entry = timed_rtf(hstep, hst0, hx, NBH * hana.blocksize / FS,
                           cost=hcost, floor_bytes=hfloor)
        entry["n_instances"] = 1
        report.config("hades_binaural_bmvdr", entry)

        NBHB = 4   # batched instances prefer short chunks (working set;
        #            NBHB sweep on-chip: 2→2649, 4→2811, 8→2440, 16→2249,
        #            32→2205 aggregate RTF — 4 is the resident sweet spot)
        hxb = hx[:NBHB]
        hbst = hpipe.init_state_batched(NB)
        hbxs = jax.jit(lambda x: jax.vmap(
            lambda i: jnp.roll(x, 13 * (i + 1), -1))(jnp.arange(NB)))(hxb)

        def hstep_b(st, xs):
            st, ys = jax.vmap(hpipe._chunk_fn,
                              in_axes=(0, 0, None, None))(st, xs, heq, hbal)
            return jnp.sum(ys * ys), st

        hbcost = probe_cost(hstep_b, hbst, hbxs, trips=1)
        hbfloor = algo_floor(hbxs, hbst,
                             out_bytes=4 * NB * 2 * NBHB * hana.blocksize,
                             trips=NBHB)
        entry = timed_rtf(hstep_b, hbst, hbxs,
                           NB * NBHB * hana.blocksize / FS, cost=hbcost,
                           floor_bytes=hbfloor)
        entry["n_instances"] = NB
        report.config(f"hades_binaural_bmvdr_{NB}x", entry)
    if not SMOKE:
        guarded("hades", 420.0, run_hades)

    # powermap + sldoa: SH-domain analysers (complex-free RI chain).
    # The _32x rows run the NATIVE batched entry points (analysis_batched /
    # analysis_chunks with a leading instance axis — one batched analysis
    # for all instances) instead of vmapping the single-instance body.
    def run_powermap_sldoa():
        from spatial_audio_framework_tpu.models import powermap as PM
        from spatial_audio_framework_tpu.models import sldoa as SL
        from spatial_audio_framework_tpu.ops import afstft_ri as ri_ops
        pmc = PM.PowermapConfig(master_order=3, mode=PM.PM_MUSIC, norm="n3d")
        pmw = PM.design(pmc)
        ax = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (pmc.nsh, Tc)).astype(np.float32)))
        axb = roll_instances(ax, NB)           # (K, NB, nsh, Tc)
        n_interp = pmw.interp_dirs_deg.shape[0]

        def mstep(st, xs):   # whole dispatch: analysis_chunks hoists the
            pm, st = PM.analysis_chunks(pmc, pmw, st, xs)   # EVD over chunks
            return jnp.sum(pm), st

        # cost: the front+SCM scan body (counted per chunk) + the hoisted
        # batched map stage (counted once) — XLA counts a while body ONCE
        def pm_scm_body(carry, xk):
            bank, cre, cim = carry
            xc = pmw.conv_in @ xk
            (sre, sim), bank = ri_ops.analysis_ri(pmc.afstft, bank, xc)
            cre, cim = PM._scm_update(pmc, cre, cim, sre, sim)
            return (bank, cre, cim), 0.0

        mst0 = PM.init_state(pmc, pmw)
        carry0 = (mst0.bank, mst0.Cx_re, mst0.Cx_im)
        f1, b1 = probe_cost(pm_scm_body, carry0, ax[0], trips=K)
        cstack = jnp.zeros((K,) + mst0.Cx_re.shape, jnp.float32)
        f2, b2 = probe_cost(
            lambda a, b: PM._map_from_cov(pmc, pmw, a, b, None),
            cstack, cstack, trips=1)
        mcost = (f1 + f2, b1 + b2)
        mfloor = algo_floor(ax, mst0, (pmw.Y_grid, pmw.interp_table,
                                       pmw.conv_in, pmw.band_mask),
                            out_bytes=4 * K * n_interp, trips=K, w_trips=1)
        report.config("powermap_o3_music", timed_rtf(
            mstep, mst0, ax, K * Tc / FS, cost=mcost, floor_bytes=mfloor))

        mbst = PM.init_state_batched(pmc, pmw, NB)
        mbcost = (NB * f1 + NB * f2, NB * b1 + NB * b2)
        mbfloor = algo_floor(axb, mbst, (pmw.Y_grid, pmw.interp_table,
                                         pmw.conv_in, pmw.band_mask),
                             out_bytes=4 * K * NB * n_interp, trips=K,
                             w_trips=1)
        entry = timed_rtf(mstep, mbst, axb, NB * K * Tc / FS,
                           cost=mbcost, floor_bytes=mbfloor)
        entry["n_instances"] = NB
        entry["memory"] = probe_mem(mstep, mbst, axb)
        report.config(f"powermap_o3_music_{NB}x", entry)

        slc = SL.SldoaConfig(master_order=3, norm="n3d")
        slw = SL.design(slc)
        n_bs = slc.afstft.n_bands * slc.max_sectors

        def sbody(st, xk):
            out, st = SL.analysis(slc, slw, st, xk)
            return st, jnp.sum(out.energy)

        sst0 = SL.init_state(slc)
        scost = probe_cost(sbody, sst0, ax[0], trips=K)
        sw_list = (slw.sec_coeffs, slw.conv_in)
        sfloor = algo_floor(ax, sst0, sw_list,
                            out_bytes=4 * K * n_bs * (HOPS_CHUNK * 3 + 4),
                            trips=K)
        report.config("sldoa_o3", timed_rtf(
            scan_chunks(sbody), sst0, ax, K * Tc / FS, cost=scost,
            floor_bytes=sfloor))

        def sbody_b(st, xk):
            out, st = SL.analysis_batched(slc, slw, st, xk)
            return st, jnp.sum(out.energy)

        sbst = SL.init_state_batched(slc, NB)
        sbcost = probe_cost(sbody_b, sbst, axb[0], trips=K)
        sbfloor = algo_floor(axb, sbst, sw_list,
                             out_bytes=4 * K * NB * n_bs
                             * (HOPS_CHUNK * 3 + 4), trips=K)
        entry = timed_rtf(scan_chunks(sbody_b), sbst, axb,
                           NB * K * Tc / FS, cost=sbcost,
                           floor_bytes=sbfloor)
        entry["n_instances"] = NB
        report.config(f"sldoa_o3_{NB}x", entry)
    if not SMOKE:
        guarded("powermap_sldoa", 420.0, run_powermap_sldoa)

    # ambi_enc: order-1 SH encoding, 64 mono sources w/ streaming directions
    def run_ambi_enc():
        from spatial_audio_framework_tpu.models import ambi_enc as ENC
        ecfg = ENC.AmbiEncConfig(order=1, n_sources=64)
        eout = ENC.design(ecfg)
        edirs = jnp.asarray(rng.uniform(-180, 180, (64, 2)).astype(
            np.float32) * np.array([1.0, 0.45], np.float32))
        ex = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (64, Tc)).astype(np.float32)))

        FR = ecfg.frame_size

        def efstep(st, xf):
            y, st = ENC.process(ecfg, eout, st, xf, edirs)
            return st, jnp.sum(y * y)

        def ebody(st, xk):
            # ambi_enc crossfades per fixed-size frame: scan frames in-chunk
            frames = jnp.moveaxis(xk.reshape(64, Tc // FR, FR), 1, 0)
            st, es = jax.lax.scan(efstep, st, frames)
            return st, jnp.sum(es)

        est0 = ENC.init_state(ecfg, np.asarray(edirs))
        ecost = probe_cost(efstep, est0,
                           jnp.zeros((64, FR), jnp.float32),
                           trips=K * (Tc // FR))
        efloor = algo_floor((ex, edirs), est0, (eout,),
                            out_bytes=4 * K * ecfg.nsh * Tc,
                            trips=K * (Tc // FR))
        report.config("ambi_enc_o1_64src", timed_rtf(
            scan_chunks(ebody), est0, ex, 64 * K * Tc / FS, cost=ecost,
            floor_bytes=efloor))
    guarded("ambi_enc", 300.0, run_ambi_enc)

    # panner: VBAP to 5.1 and 7.1.4, 64 streams x 4 sources
    def run_panner():
        from spatial_audio_framework_tpu.models import panner as PAN
        layouts = {
            "5_1": np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]],
                            np.float64),
            "7_1_4": np.array(
                [[30, 0], [-30, 0], [0, 0], [90, 0], [-90, 0], [135, 0],
                 [-135, 0], [45, 45], [-45, 45], [135, 45], [-135, 45]],
                np.float64),
        }
        px = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (64, 4, Tc)).astype(np.float32)))
        pdirs = jnp.asarray(rng.uniform(-180, 180, (64, 4, 2)).astype(
            np.float32) * np.array([1.0, 0.45], np.float32))
        for name, ls in layouts.items():
            pcfg = PAN.PannerConfig(n_sources=4, n_loudspeakers=len(ls))
            pw = PAN.design(pcfg, ls)

            def pbody(st, xk, pw=pw, pcfg=pcfg):
                y, st = PAN.process_ri_batched(pcfg, pw, st, xk, pdirs)
                return st, jnp.sum(y * y)

            pst0 = PAN.init_state_batched(pcfg, 64, len(ls))
            pcost = probe_cost(pbody, pst0, px[0], trips=K)
            pfloor = algo_floor((px, pdirs), pst0, (pw,),
                                out_bytes=4 * K * 64 * len(ls) * Tc,
                                trips=K)
            report.config(f"panner_{name}_64streams", timed_rtf(
                scan_chunks(pbody), pst0, px, 64 * K * Tc / FS, cost=pcost,
                floor_bytes=pfloor))
    if not SMOKE:
        guarded("panner", 420.0, run_panner)

    # tvconv: time-varying partitioned convolution, streaming listener pos
    def run_tvconv():
        from spatial_audio_framework_tpu.models import conv_examples as CE
        tv = CE.TVConvExample()
        irs = 0.1 * rng.standard_normal((64, 2, 2048)).astype(np.float32)
        irs[:, :, 0] += 1.0
        pos = rng.uniform(0, 5, (64, 3)).astype(np.float32)
        conv, Hri, posd = tv.design_ri(irs, pos)
        lpos = jnp.asarray(pos[3])
        tx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (Tc,)).astype(np.float32)))

        tst0 = tv.init_state_ri(conv)
        tfloor = algo_floor((tx, lpos), tst0, (Hri, posd),
                            out_bytes=4 * K * 2 * Tc, trips=K)

        # PRIMARY row — a MOVING listener: the nearest stored position
        # changes every chunk, so the whole-block change predicate fires
        # and the full crossfade path (current + two previous filter-set
        # convolutions) is exercised: the honest time-VARYING workload
        # this example exists for.  The `_32x` row below moves too.
        lpos_seq = jnp.asarray(pos[:K])

        def tbody_mv(st, inp):
            xk, lp = inp
            y, st = tv.process_ri(conv, Hri, st, xk, lp, posd)
            return st, jnp.sum(y * y)

        def tstep_mv(st, xs):
            st, es = jax.lax.scan(tbody_mv, st, xs)
            return jnp.sum(es), st

        tmcost = probe_cost(tbody_mv, tst0, (tx[0], lpos_seq[0]), trips=K)
        report.config("tvconv_64pos_2ch", timed_rtf(
            tstep_mv, tst0, (tx, lpos_seq), K * Tc / FS, cost=tmcost,
            floor_bytes=tfloor))

        # STATIC listener: the whole-block lax.cond skips the two dead
        # crossfade convolutions (as the C only convolves previous filter
        # sets on a change) — the steady-state fast path
        def tbody(st, xk):
            y, st = tv.process_ri(conv, Hri, st, xk, lpos, posd)
            return st, jnp.sum(y * y)

        tcost = probe_cost(tbody, tst0, tx[0], trips=K)
        report.config("tvconv_64pos_2ch_static", timed_rtf(
            scan_chunks(tbody), tst0, tx, K * Tc / FS, cost=tcost,
            floor_bytes=tfloor))

        # native batched MOVING instances (leading batch dims, no vmap):
        # every instance's position changes every chunk
        txb = roll_instances(tx, NB)           # (K, NB, Tc)
        lpos_seq_b = jnp.asarray(
            pos[(np.arange(K)[:, None] * NB + np.arange(NB)[None, :])
                % pos.shape[0]])                   # (K, NB, 3)

        def tbody_bmv(st, inp):
            xk, lp = inp
            y, st = tv.process_ri(conv, Hri, st, xk, lp, posd)
            return st, jnp.sum(y * y)

        def tstep_bmv(st, xs):
            st, es = jax.lax.scan(tbody_bmv, st, xs)
            return jnp.sum(es), st

        tbst = conv.init_state_ri(batch=(NB,))
        tbcost = probe_cost(tbody_bmv, tbst, (txb[0], lpos_seq_b[0]),
                            trips=K)
        tbfloor = algo_floor((txb, lpos_seq_b), tbst, (Hri, posd),
                             out_bytes=4 * K * NB * 2 * Tc, trips=K)
        entry = timed_rtf(tstep_bmv, tbst, (txb, lpos_seq_b),
                           NB * K * Tc / FS, cost=tbcost,
                           floor_bytes=tbfloor)
        entry["n_instances"] = NB
        report.config(f"tvconv_64pos_2ch_{NB}x", entry)
    if not SMOKE:
        guarded("tvconv", 420.0, run_tvconv)

    # ambi_roomsim: shoebox image-source reverb -> partitioned MatrixConv
    def run_roomsim():
        from spatial_audio_framework_tpu.models import ambi_roomsim as RS
        rcfg = RS.AmbiRoomSimConfig(n_sources=2, n_receivers=1, sh_order=2,
                                    refl_order=2)
        rw = RS.design_ri(rcfg, np.array([[2.0, 3.0, 1.5], [4.0, 2.0, 1.7]]),
                          np.array([[3.0, 2.5, 1.6]]))
        rx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (2, Tc)).astype(np.float32)))

        def rbody(st, xk):
            y, st = RS.process_ri(rcfg, rw, st, xk)
            return st, jnp.sum(y * y)

        rst0 = RS.init_state_ri(rcfg, rw)
        rcost = probe_cost(rbody, rst0, rx[0], trips=K)
        n_sh_out = rw.conv.n_out
        rfloor = algo_floor(rx, rst0, rw.Hf,
                            out_bytes=4 * K * n_sh_out * Tc, trips=K)
        report.config("ambi_roomsim_o2_2src", timed_rtf(
            scan_chunks(rbody), rst0, rx, K * Tc / FS, cost=rcost,
            floor_bytes=rfloor))

        # native batched instances (grouped-conv spectral core engages at
        # this batch size — ops.matrix_conv._conv_core_ri)
        rxb = roll_instances(rx, NB)
        rbst = rw.conv.init_state_ri(batch=(NB,))
        rbcost = probe_cost(rbody, rbst, rxb[0], trips=K)
        rbfloor = algo_floor(rxb, rbst, rw.Hf,
                             out_bytes=4 * K * NB * n_sh_out * Tc, trips=K)
        entry = timed_rtf(scan_chunks(rbody), rbst, rxb,
                           NB * K * Tc / FS, cost=rbcost,
                           floor_bytes=rbfloor)
        entry["n_instances"] = NB
        report.config(f"ambi_roomsim_o2_2src_{NB}x", entry)
    if not SMOKE:
        guarded("ambi_roomsim", 420.0, run_roomsim)

    # ambi_dec: order-1 AllRAD decode to 5 loudspeakers, 64 streams
    def run_ambi_dec():
        from spatial_audio_framework_tpu.models import ambi_dec as ADC
        als = np.array([[30.0, 0], [-30, 0], [110, 0], [-110, 0], [0, 90]],
                       np.float64)
        acfg = ADC.AmbiDecConfig(master_order=1)
        aw = ADC.design_ri(acfg, als)
        adx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (64, acfg.nsh, Tc)).astype(np.float32)))

        def adbody(st, xk):
            y, st = ADC.process_ri_batched(acfg, aw, st, xk)
            return st, jnp.sum(y * y)

        adst0 = ADC.init_state_batched(acfg, 64, len(als))
        adcost = probe_cost(adbody, adst0, adx[0], trips=K)
        adfloor = algo_floor(adx, adst0, (aw,),
                             out_bytes=4 * K * 64 * len(als) * Tc, trips=K)
        report.config("ambi_dec_o1_5ls_64streams", timed_rtf(
            scan_chunks(adbody), adst0, adx, 64 * K * Tc / FS, cost=adcost,
            floor_bytes=adfloor))
    if not SMOKE:
        guarded("ambi_dec", 300.0, run_ambi_dec)

    # array2sh: Eigenmike32 -> order-4 SH encoding, 16 streams
    def run_array2sh():
        from spatial_audio_framework_tpu.models import array2sh as A2S
        from spatial_audio_framework_tpu.utils import presets as _presets
        em32 = np.degrees(_presets.mic_preset("eigenmike32"))
        a2cfg = A2S.Array2SHConfig(order=4)
        a2w = A2S.design_ri(a2cfg, em32)
        a2x = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (16, em32.shape[0], Tc)).astype(np.float32)))

        def a2body(st, xk):
            y, st = A2S.process_ri_batched(a2cfg, a2w, st, xk)
            return st, jnp.sum(y * y)

        a2st0 = A2S.init_state_batched(a2cfg, 16, em32.shape[0])
        a2cost = probe_cost(a2body, a2st0, a2x[0], trips=K)
        a2floor = algo_floor(a2x, a2st0, (a2w,),
                             out_bytes=4 * K * 16 * a2cfg.nsh * Tc, trips=K)
        report.config("array2sh_em32_o4_16streams", timed_rtf(
            scan_chunks(a2body), a2st0, a2x, 16 * K * Tc / FS, cost=a2cost,
            floor_bytes=a2floor))
    if not SMOKE:
        guarded("array2sh", 300.0, run_array2sh)

    # decorrelator: 4-channel lattice decorrelation, 16 streams
    def run_decorrelator():
        from spatial_audio_framework_tpu.models import decorrelator as DCR
        dcfg = DCR.DecorrelatorConfig(n_channels=4,
                                      enable_transient_ducker=False)
        dw = DCR.design(dcfg)
        ddx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (16, 4, Tc)).astype(np.float32)))

        def dbody(st, xk):
            y, st = DCR.process_ri_batched(dcfg, dw, st, xk)
            return st, jnp.sum(y * y)

        dst0 = DCR.init_state_batched(dcfg, dw, 16)
        dcost = probe_cost(dbody, dst0, ddx[0], trips=K)
        dfloor = algo_floor(ddx, dst0, (dw,),
                            out_bytes=4 * K * 16 * 4 * Tc, trips=K)
        report.config("decorrelator_4ch_16streams", timed_rtf(
            scan_chunks(dbody), dst0, ddx, 16 * K * Tc / FS, cost=dcost,
            floor_bytes=dfloor))
    if not SMOKE:
        guarded("decorrelator", 300.0, run_decorrelator)

    # spreader: 1 source, OM mode (CDF4SAP + lattice per frame)
    def run_spreader():
        from spatial_audio_framework_tpu.models import spreader as SPRD
        scfg = SPRD.SpreaderConfig(n_sources=1, mode=SPRD.MODE_OM)
        sw = SPRD.design(scfg)
        sdirs = jnp.asarray(np.array([[40.0, 10.0]], np.float32))
        sspread = jnp.asarray(np.array([60.0], np.float32))
        FRS = 512          # the C spreader's own default SPREADER_FRAME_SIZE
        NFR = 32           # frames per chunk (throughput sweet spot)
        spx = jax.jit(lambda x: jax.vmap(lambda k: jnp.roll(x, k + 1, -1))(
            jnp.arange(K)))(jnp.asarray(rng.uniform(
                -1, 1, (1, NFR * FRS)).astype(np.float32)))

        def spbody(st, xk):
            # scan-free frame-batched path (models/spreader.process_chunk):
            # NFR frames per inner chunk, EWMAs as triangular matmuls
            frames = jnp.moveaxis(xk.reshape(1, NFR, FRS), 1, 0)
            y, st = SPRD.process_chunk(scfg, sw, st, frames, sdirs, sspread)
            return st, jnp.sum(y * y)

        spst0 = SPRD.init_state(scfg, sw)
        fr0 = jnp.moveaxis(spx[0].reshape(1, NFR, FRS), 1, 0)
        spcost = probe_cost(
            lambda st, fr: SPRD.process_chunk(scfg, sw, st, fr, sdirs,
                                              sspread),
            spst0, fr0, trips=K)
        y_sh = jax.eval_shape(
            lambda st, fr: SPRD.process_chunk(scfg, sw, st, fr, sdirs,
                                              sspread), spst0, fr0)[0]
        spfloor = algo_floor((spx, sdirs, sspread), spst0, (sw,),
                             out_bytes=4 * K * int(np.prod(y_sh.shape)),
                             trips=K)
        report.config("spreader_om_1src", timed_rtf(
            scan_chunks(spbody), spst0, spx, K * NFR * FRS / FS,
            cost=spcost, floor_bytes=spfloor))
        # chip-loaded: NB independent spreader instances per dispatch
        # (shorter 8-frame chunks: the 32-frame footprint x 32 instances
        # spills; 8 frames keeps the batched working set resident)
        NFRB = 8
        spxb = spx[:, :, :NFRB * FRS]

        def spbody_b(st, xk):
            frames = jnp.moveaxis(xk.reshape(1, NFRB, FRS), 1, 0)
            y, st = SPRD.process_chunk(scfg, sw, st, frames, sdirs, sspread)
            return st, jnp.sum(y * y)

        vb, vst, vxs = batch_instances(spbody_b, spst0, spxb)
        # probe the 8-frame body directly: the chunk path's EWMA-as-
        # triangular-matmul work scales QUADRATICALLY in frames-per-chunk,
        # so rescaling the 32-frame cost linearly overstated it ~4x
        spcost_b1 = probe_cost(
            lambda st, fr: SPRD.process_chunk(scfg, sw, st, fr, sdirs,
                                              sspread),
            spst0, jnp.moveaxis(spxb[0].reshape(1, NFRB, FRS), 1, 0),
            trips=K)
        spc_b = tuple(NB * c for c in spcost_b1)
        spfloor_b = algo_floor((vxs, sdirs, sspread), vst, (sw,),
                               out_bytes=4 * K * NB
                               * int(np.prod(y_sh.shape)) * NFRB // NFR,
                               trips=K)
        entry = timed_rtf(scan_chunks(vb), vst, vxs,
                           NB * K * NFRB * FRS / FS, cost=spc_b,
                           floor_bytes=spfloor_b)
        entry["n_instances"] = NB
        report.config(f"spreader_om_1src_{NB}x", entry)
    if not SMOKE:
        guarded("spreader", 420.0, run_spreader)

    watchdog.stop()
    report.emit(status="complete")


if __name__ == "__main__":
    main()
