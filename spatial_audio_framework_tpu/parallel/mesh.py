"""Device-mesh scaling for multi-stream rendering.

The reference is single-device; its only "backend" axis is a compile-time
BLAS/FFT dispatch (saf_externals.h:78-273).  Here the scale axis is a
``jax.sharding.Mesh`` over which independent audio streams are data-parallel
('dp') and the SH/channel dimension of the per-band decode contractions can
be tensor-parallel ('tp'), with XLA inserting the collectives between the
devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1) -> Mesh:
    """Create a ('dp', 'tp') mesh.  Default: all devices on 'dp'."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, (dp, tp, n)
    arr = np.asarray(devs[:n]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def stream_sharding(mesh: Mesh, shard_channels: bool = False) -> NamedSharding:
    """Sharding for (streams, channels, time) blocks: streams on 'dp', and
    optionally channels on 'tp'."""
    return NamedSharding(mesh, P("dp", "tp" if shard_channels else None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading(tree, mesh: Mesh):
    """Place every leaf of a batched state pytree with its leading (stream)
    axis on 'dp'."""
    def put(leaf):
        spec = P("dp", *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)
