"""spatial_audio_framework_tpu — a spatial-audio DSP framework for accelerators.

A ground-up JAX/XLA re-design with the capabilities of the Spatial Audio
Framework (SAF v1.3.0, reference: github.com/ChristianScheer97/Spatial_Audio_Framework):
Ambisonics encoding/decoding, spherical-harmonic array processing, VBAP,
HRTF/binaural rendering, room simulation and convolution engines.

Architecture (a re-design for accelerators, not a port):

* Every renderer is split into a host-side ``design()`` step (NumPy/SciPy,
  runs once per configuration change — the analogue of SAF's ``initCodec``)
  and a pure, jit-compiled ``process()`` step operating on fixed-shape blocks
  (the analogue of SAF's 128-sample audio callback, but batched over many
  hops and many streams at once).
* Per-frequency-band loops in the reference become stacked batched einsums
  that map onto the accelerator's matrix units; filterbank state is carried functionally
  through ``lax.scan``/explicit state pytrees instead of mutable handles.
* Multi-stream scaling uses ``jax.sharding`` over a device mesh
  (see ``spatial_audio_framework_tpu.parallel``) rather than any
  message-passing backend.

Subpackage map (reference layers in parentheses — see SURVEY.md):

* ``utils``    — geometry, filters, windows, presets       (saf_utilities L2)
* ``ops``      — FFT/afSTFT/QMF/convolvers/veclib          (resources L1 + L2 hot ops)
* ``modules``  — sh, hoa, vbap, hrir, cdf4sap, reverb, ...  (L3 domain modules)
* ``models``   — the plugin-style renderers (ambi_bin, ...) (L4 examples)
* ``parallel`` — mesh/sharding/streaming engine             (new)
"""

__version__ = "0.1.0"

from spatial_audio_framework_tpu import utils, ops, modules, models, parallel  # noqa: F401


def version_banner() -> str:
    """Version/config banner (analogue of SAF_VERSION_BANNER, saf.h:115-122,
    and SAF_EXTERNALS_CONFIGURATION_STRING, saf_externals.h:362-369)."""
    import jax

    backends = ",".join(sorted({d.platform for d in jax.devices()}))
    return (f"spatial_audio_framework_tpu v{__version__} | "
            f"jax {jax.__version__} | devices: {backends} "
            f"({len(jax.devices())} visible)")
