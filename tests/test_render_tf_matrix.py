"""The batched TF-matrix render (ops/afstft_ri.render_tf_matrix_ri) across
the shapes its renderers use, and the GPU smoke script's refusals.

Each case renders two blocks with state carry and must match the complex
afSTFT path (ops/afstft.py), an independent reference.
``test_render_on_gpu_meets_budget`` runs on the card and skips elsewhere.
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spatial_audio_framework_tpu.ops import afstft_ri as ri
from spatial_audio_framework_tpu.ops.afstft import AfSTFT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(rng, S, cin, cout, H, per_stream, hybrid, low_delay, n_blocks=2):
    bank = AfSTFT(hop=128, hybrid=hybrid, low_delay=low_delay)
    shp = ((S,) if per_stream else ()) + (bank.n_bands, cout, cin)
    scale = 1.0 / np.sqrt(cin)
    Mre = (scale * rng.standard_normal(shp)).astype(np.float32)
    Mim = (scale * rng.standard_normal(shp)).astype(np.float32)
    xs = [rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)
          for _ in range(n_blocks)]
    return bank, Mre, Mim, xs


def _batched(bank, Mre, Mim, xs, precision=None):
    S, cin = xs[0].shape[:2]
    st = ri.init_state_batched(bank, S, cin, Mre.shape[-2])
    render = jax.jit(lambda s, x: ri.render_tf_matrix_ri(
        bank, s, x, jnp.asarray(Mre), jnp.asarray(Mim), precision=precision))
    ys = []
    for x in xs:
        y, st = render(st, jnp.asarray(x))
        ys.append(np.asarray(y))
    return np.concatenate(ys, -1)


def _complex(bank, Mre, Mim, xs):
    M = (Mre + 1j * Mim).astype(np.complex64)
    S, cin = xs[0].shape[:2]
    cout = M.shape[-2]
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def step(st, x, Ms):
        spec, st = bank.analysis(st, x)
        return bank.synthesis(st, jnp.einsum("bes,bsh->beh", Ms, spec,
                                             precision=hi))
    ys = []
    for s in range(S):
        st = bank.init_state(cin, cout)
        Ms = jnp.asarray(M[s] if M.ndim == 4 else M)
        out = []
        for x in xs:
            y, st = step(st, jnp.asarray(x[s]), Ms)
            out.append(np.asarray(y))
        ys.append(np.concatenate(out, -1))
    return np.stack(ys)


# (S, Cin, Cout, H, per_stream, hybrid, low_delay): Cin 4/16/25 with shared
# and per-stream matrices, the hybrid stage on and off, low delay, blocks
# shorter than the 9-hop OLA tail, odd stream and channel counts, and 1, 2
# and 5 outputs.
RENDER_CASES = [
    (3, 4, 2, 40, False, True, False),
    (2, 16, 2, 8, True, True, False),
    (1, 25, 2, 4, False, True, False),
    (3, 4, 2, 17, True, False, False),
    (2, 6, 2, 5, False, True, True),
    (5, 3, 2, 2, False, False, True),
    (2, 5, 1, 3, True, True, False),
    (2, 2, 5, 6, False, True, False),
]


@pytest.mark.parametrize("S,cin,cout,H,per_stream,hybrid,low_delay",
                         RENDER_CASES)
def test_batched_render_matches_complex_path(S, cin, cout, H, per_stream,
                                             hybrid, low_delay):
    rng = np.random.default_rng(cin * 100 + H)
    bank, Mre, Mim, xs = _case(rng, S, cin, cout, H, per_stream, hybrid,
                               low_delay)
    y = _batched(bank, Mre, Mim, xs)
    y_ref = _complex(bank, Mre, Mim, xs)
    assert np.abs(y_ref).max() > 0
    np.testing.assert_allclose(y, y_ref, atol=2e-5)


def _run_chip_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    p = _run_chip_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_chip_smoke(str(tmp_path), script)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.mark.gpu
def test_render_on_gpu_meets_budget(gpu):
    """At the hot precision the card's render stays within the 1e-4
    budget of the complex reference at HIGHEST."""
    rng = np.random.default_rng(9)
    bank, Mre, Mim, xs = _case(rng, 61, 16, 2, 64, True, True, False)
    np.testing.assert_allclose(_batched(bank, Mre, Mim, xs),
                               _complex(bank, Mre, Mim, xs), atol=1e-4)
