"""Explicit host<->device transfer helpers.

Every hot-path upload/download goes through these (or device_put /
device_get directly) so the production pipelines run clean under
``jax.transfer_guard("disallow")``: an implicit transfer on an O(sn)
array would silently serialize on the host link, and an implicit scalar
transfer inside a dispatch loop adds a blocking round trip per call. ``tests/test_transfer_guard.py`` enforces the
invariant (SURVEY §5 race-detection/sanitizer row)."""
from __future__ import annotations

import jax
import numpy as np


def put(a):
    """Explicit host->device upload."""
    return jax.device_put(a)


def get(a):
    """Explicit device->host download (transfer-guard-clean np.asarray)."""
    return jax.device_get(a)


def put_i32(v):
    """Upload a Python/numpy scalar as a device int32."""
    return jax.device_put(np.int32(v))


def get_global(a):
    """Host copy of a possibly multi-process (non-fully-addressable)
    array: plain download when this process sees every shard, else a
    ``process_allgather`` so each process reconstructs the global value
    (the multi-host form of the sharded merge's result fetches)."""
    import jax

    try:
        fully = a.is_fully_addressable
    except AttributeError:
        fully = True
    if fully:
        return jax.device_get(a)
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(a, tiled=True)
