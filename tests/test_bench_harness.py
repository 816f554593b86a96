"""CI gate for bench.py's un-losable emission protocol and its device
tables.

These tests fail if anyone reintroduces print-only-at-the-end:

* BenchReport emits a full, parseable JSON line on every update (a reader
  parses the LAST line);
* the Watchdog daemon thread fires on a hung operation and on budget
  exhaustion even while the "main" thread is blocked (a Python signal
  handler cannot run in that state — only a thread can save the run);
* SIGTERM dumps the partial JSON (subprocess test);
* an end-to-end CPU smoke run of bench.py (SAF_BENCH_SMOKE=1) emits the
  flagship value on its FIRST value-carrying line, before any sub-config,
  and every line is parseable.

They also pin the per-device peaks table and the compile-cache location.
"""
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from spatial_audio_framework_tpu.runtime.watchdog import Watchdog  # noqa: E402


def parse_lines(text):
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return [json.loads(ln) for ln in lines]


def test_report_emits_full_parseable_json_each_time():
    buf = io.StringIO()
    r = bench.BenchReport("m", "u", stream=buf)
    r.emit(status="starting")
    r.set_value(1234.5)
    r.emit(status="flagship done")
    r.config("sub", {"rtf": 7.0})
    r.emit(status="after sub")
    recs = parse_lines(buf.getvalue())
    # each emit prints the full enriched line + a compact line
    assert len(recs) == 6
    for rec in recs:
        assert set(rec) >= {"metric", "value", "unit", "vs_baseline", "extra"}
    fulls = [x for x in recs if not x["extra"].get("compact")]
    compacts = [x for x in recs if x["extra"].get("compact")]
    assert len(fulls) == 3 and len(compacts) == 3
    # flagship value lands BEFORE the sub-config does
    assert fulls[1]["value"] == 1234.5 and fulls[1]["vs_baseline"] == 12.345
    assert "sub" not in fulls[1]["extra"]["config_rtfs"]
    assert fulls[2]["extra"]["config_rtfs"]["sub"] == {"rtf": 7.0}
    # last line is COMPACT (driver tail-capture safe) and carries the value
    assert recs[-1]["extra"]["compact"] is True
    assert recs[-1]["value"] == 1234.5
    assert recs[-1]["extra"]["n_configs"] == 1


def test_compact_line_stays_under_cap(tmp_path):
    """An enriched final line runs to several KB, and a reader that keeps
    only a ~2000-char tail would truncate it mid-JSON.  The compact line
    must stay under the cap with a FULLY populated report
    (a 21-config run with roofline fields, errors, skips, long status)."""
    buf = io.StringIO()
    r = bench.BenchReport("ambi_bin_order3_magls_64streams_rtf",
                          "audio_sec/sec/device", stream=buf,
                          artifact_path=str(tmp_path / "bench_full.json"))
    r.set_value(11049.3)
    r.extra(ms_per_dispatch_flagship=7.918,
            max_abs_err_vs_c_reference=7.1e-5,
            max_abs_err_vs_cpu_f32=1.2e-5,
            p50_block_latency_ms_85ms_block=30.2,
            matmul_precision="highest",
            calibration={"matmul_bf16_tflops": 182.8,
                         "matmul_f32_hot_tflops": 62.7, "hbm_gbps": 695.8},
            flagship_roofline={k: 1.0 for k in range(20)})
    for i in range(21):
        r.config(f"config_with_a_fairly_long_name_{i:02d}_64streams", {
            "rtf": 4000.0 + i, "ms_per_dispatch": 3.5,
            "gflops_per_audio_sec": 12.3, "achieved_tflops": 1.1,
            "mfu_pct_nominal": 0.5, "mfu_pct_achievable": 1.7,
            "hbm_gbps_xla_est": 400.0, "hbm_pct_xla_est": 50.0,
            "hbm_pct_measured": 60.0, "bound": "dispatch/overhead",
            "memory": {"temp_mb": 514.1, "args_mb": 60.0, "output_mb": 1.0},
        })
    for i in range(5):
        r.error(f"errcfg{i}", "Traceback: " + "x" * 400)
    r.skipped("skipped_config_a")
    r.emit(status="a deliberately long status string " * 8)
    recs = parse_lines(buf.getvalue())
    last = recs[-1]
    last_line = buf.getvalue().strip().splitlines()[-1]
    assert len(last_line.encode()) <= bench.BenchReport.COMPACT_MAX_BYTES
    assert last["extra"]["compact"] is True
    assert last["value"] == 11049.3 and last["vs_baseline"] == 110.493
    assert last["extra"]["ms_per_dispatch_flagship"] == 7.918
    assert last["extra"]["max_abs_err_vs_c_reference"] == 7.1e-5
    assert last["extra"]["n_configs"] == 21
    assert last["extra"]["n_errors"] == 5
    assert last["extra"]["artifact"] == "bench_full.json"


def test_artifact_file_rewritten_on_each_emit(tmp_path):
    art = str(tmp_path / "art.json")
    buf = io.StringIO()
    r = bench.BenchReport("m", "u", stream=buf, artifact_path=art)
    r.set_value(5.0)
    r.emit(status="one")
    rec = json.loads(open(art).read())
    assert rec["value"] == 5.0 and not rec["extra"].get("compact")
    r.config("sub", {"rtf": 7.0})
    r.emit(status="two")
    rec = json.loads(open(art).read())
    assert rec["extra"]["config_rtfs"]["sub"]["rtf"] == 7.0


def test_watchdog_fires_on_hung_operation():
    buf = io.StringIO()
    r = bench.BenchReport("m", "u", stream=buf)
    r.set_value(42.0)
    fired = threading.Event()
    exits = []

    wd = Watchdog(on_expire=lambda reason: (r.emit(status=reason),
                                            fired.set()),
                  budget_s=None, poll_s=0.05,
                  exit_fn=lambda code: exits.append(code))
    wd.begin("hung_fence", timeout_s=0.15)
    assert fired.wait(5.0), "watchdog did not fire on a hung operation"
    wd.stop()
    assert exits == [0]
    recs = parse_lines(buf.getvalue())
    assert recs[-1]["value"] == 42.0  # partials preserved
    assert "hung_fence" in recs[-1]["extra"]["status"]


def test_watchdog_fires_on_budget_exhaustion():
    buf = io.StringIO()
    r = bench.BenchReport("m", "u", stream=buf)
    fired = threading.Event()
    wd = Watchdog(on_expire=lambda reason: (r.emit(status=reason),
                                            fired.set()),
                  budget_s=0.15, poll_s=0.05,
                  exit_fn=lambda code: None)
    assert fired.wait(5.0), "watchdog did not fire on budget exhaustion"
    wd.stop()
    recs = parse_lines(buf.getvalue())
    assert "budget" in recs[-1]["extra"]["status"]


def test_watchdog_end_cancels_deadline():
    fired = threading.Event()
    wd = Watchdog(on_expire=lambda reason: fired.set(), budget_s=None,
                  poll_s=0.02, exit_fn=lambda code: None)
    wd.begin("quick_op", timeout_s=0.2)
    wd.end()
    time.sleep(0.4)
    wd.stop()
    assert not fired.is_set()


def test_watchdog_end_at_deadline_does_not_fire():
    """TOCTOU guard (round-4 advisor): an op that end()s within one poll
    interval of its already-passed deadline must never be force-exited —
    expiry is decided and latched under the same lock end() takes."""
    fired = threading.Event()
    wd = Watchdog(on_expire=lambda reason: fired.set(), budget_s=None,
                  poll_s=0.25, exit_fn=lambda code: None)
    wd.begin("op", timeout_s=0.0)  # deadline already passed
    wd.end()                       # ...but completed before the next poll
    time.sleep(0.7)
    wd.stop()
    assert not fired.is_set()


def test_watchdog_reason_reports_actual_timeout():
    reasons = []
    wd = Watchdog(on_expire=reasons.append, budget_s=None, poll_s=0.05,
                  exit_fn=lambda code: None)
    wd.begin("slow_op", timeout_s=0.15)
    time.sleep(0.5)
    wd.stop()
    assert reasons and "slow_op" in reasons[0]
    assert "0.15s deadline" in reasons[0]


def test_sigterm_dumps_partial_json():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import bench\n"
        "r = bench.BenchReport('m', 'u')\n"
        "bench.install_signal_handlers(r)\n"
        "r.set_value(99.0)\n"
        "print('READY', flush=True)\n"
        "time.sleep(30)\n")
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    assert p.stdout.readline().strip() == "READY"
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=20)
    assert p.returncode == 0  # diagnosed partial = successful report
    recs = parse_lines(out)
    assert recs[-1]["value"] == 99.0
    assert "signal" in recs[-1]["extra"]["status"]


@pytest.mark.parametrize("kind", sorted(bench.PEAKS))
def test_peaks_table_known_device(kind):
    pk = bench.device_peaks(kind)
    assert set(pk) >= {"tflops_bf16", "tflops_tf32", "tflops_f32",
                       "hbm_gbps"}
    assert all(v > 0 for v in pk.values())


def test_peaks_table_h100_values():
    pk = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert (pk["tflops_bf16"], pk["tflops_tf32"], pk["hbm_gbps"]) == (
        989.0, 495.0, 3350.0)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_table_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "cache")
    assert bench.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_compile_cache_default_is_fixed_in_checkout():
    d = bench.compile_cache_dir({})
    assert d == os.path.join(REPO, ".jax_cache")
    assert bench.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == d
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.slow
@pytest.mark.goldens
def test_bench_smoke_cpu_end_to_end():
    """Full bench.py under SAF_BENCH_SMOKE=1 on CPU: flagship-first
    incremental emission, every line parseable, last line complete."""
    env = dict(os.environ)
    env.update(SAF_BENCH_SMOKE="1", JAX_PLATFORMS="cpu",
               SAF_BENCH_BUDGET_S="560")
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    recs = parse_lines(p.stdout)
    assert len(recs) >= 3, "bench must emit incrementally, not once"
    # the first FULL line that carries a value must NOT yet have
    # sub-configs: flagship is measured and reported FIRST
    first_valued = next(r for r in recs if r["value"] is not None
                        and not r["extra"].get("compact"))
    assert first_valued["extra"]["config_rtfs"] == {}
    assert first_valued["value"] > 0
    # the LAST line is the compact driver-tail-safe summary
    last = recs[-1]
    last_line = [ln for ln in p.stdout.strip().splitlines()
                 if ln.strip()][-1]
    assert len(last_line.encode()) <= bench.BenchReport.COMPACT_MAX_BYTES
    assert last["extra"].get("compact") is True
    assert last["value"] is not None
    assert last["unit"] == "audio_sec/sec/device"
    full = [r for r in recs if not r["extra"].get("compact")][-1]
    assert full["extra"]["device"]["platform"] == "cpu"
    assert full["extra"]["flagship_roofline"] == {"roofline": "not measured"}
