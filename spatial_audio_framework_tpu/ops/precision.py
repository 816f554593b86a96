"""Process-time matmul precision policy — ONE policy for every XLA matmul
and einsum on the process paths.

Three modes, mapped to ``jax.lax.Precision`` for float32 operands:
``"default"`` → DEFAULT, ``"high"`` → HIGH, ``"highest"`` → HIGHEST.  On
the CPU all three compute in float32.  On the H100 DEFAULT and HIGH both
run as TF32 (about 2e-4 relative error on the 256-point rDFT matmul) and
HIGHEST as float32 (about 6e-7); PERF.md has the measurements.

The C reference (saf_utility_veclib) computes in exact f32, so design-time
code here stays at ``EXACT`` (HIGHEST).  The per-block *process* paths use
the HOT mode, default ``"highest"``: at HIGH the flagship render on the
H100 is 6.4e-4 max-abs off HIGHEST, over the 1e-4 C-parity budget.

Per-call control: every render path takes an optional ``precision``
argument ("default"|"high"|"highest", None = this module's HOT mode),
threaded from model configs (e.g. ``AmbiBinConfig.matmul_precision``).  The
environment variable is a process default only: :func:`set_hot_precision`
changes the mode for traces executed after the call, and ``precision``
overrides it per call.

Environment: ``SAF_MATMUL_PRECISION=default|high|highest``.  An invalid
value warns and falls back to the default (never crashes the whole package
at import).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import jax

_XLA = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
VALID_MODES = tuple(_XLA)
_DEFAULT_MODE = "highest"


def normalize_mode(mode: str) -> str:
    """Canonical mode string; raises ValueError with the valid vocabulary."""
    m = str(mode).lower()
    if m not in _XLA:
        raise ValueError(
            f"invalid matmul precision mode {mode!r}: expected one of "
            f"{'|'.join(VALID_MODES)}")
    return m


def to_xla(mode: str) -> jax.lax.Precision:
    """Canonical mode string → jax.lax.Precision for XLA matmul/einsum."""
    return _XLA[normalize_mode(mode)]


def _mode_from_env() -> str:
    raw = os.environ.get("SAF_MATMUL_PRECISION")
    if raw is None:
        return _DEFAULT_MODE
    try:
        return normalize_mode(raw)
    except ValueError as e:
        warnings.warn(f"{e}; falling back to {_DEFAULT_MODE!r}",
                      stacklevel=3)
        return _DEFAULT_MODE


_HOT_MODE = _mode_from_env()

# jax.lax.Precision for process-time XLA matmuls (prefer
# resolve_mode()/to_xla() in code that supports per-call override)
HOT = _XLA[_HOT_MODE]

# Exact-f32 precision for design-time / golden-critical matmuls.
EXACT = jax.lax.Precision.HIGHEST


def hot_mode() -> str:
    """The current process-default mode string ('default'|'high'|'highest')."""
    return _HOT_MODE


def resolve_mode(mode: Optional[str] = None) -> str:
    """Per-call mode resolution: explicit argument wins, else the process
    HOT default.  Call this OUTSIDE jit boundaries (pass the result as a
    static argument) so a later :func:`set_hot_precision` is never masked
    by a stale trace cache."""
    return _HOT_MODE if mode is None else normalize_mode(mode)


def set_hot_precision(mode: str) -> None:
    """Set the process-default matmul precision ('default'|'high'|'highest').

    Takes effect for traces executed after the call (already-jitted
    executables keep the precision they were traced with).
    """
    global HOT, _HOT_MODE
    _HOT_MODE = normalize_mode(mode)
    HOT = _XLA[_HOT_MODE]
