"""Multi-process (multi-host) scaffolding: ``jax.distributed`` bring-up.

On a multi-host cluster each host process calls :func:`maybe_initialize`
before any JAX use; the global mesh returned by ``parallel.mesh.make_mesh``
then spans every process's devices and the wave program's collectives
(``ppermute`` chain shift, ``psum`` wave health) ride the device
interconnect and the network between hosts. The
reference has no distributed mechanism at all (SURVEY.md §5 last row); its
closest analogue is the ``.phrases`` disk spill that this pipeline's
per-block head exchange generalizes (ref CMS-BWT-functions.cpp:1135-1416).

Configuration comes from explicit arguments or the standard environment:

* ``CMSBWT_COORDINATOR`` (host:port of process 0)
* ``CMSBWT_NUM_PROCESSES`` / ``CMSBWT_PROCESS_ID``

or any platform auto-detection ``jax.distributed.initialize`` supports
(GKE/Slurm set these automatically — all three may then be omitted).
"""
from __future__ import annotations

import os

_INITIALIZED = False


def maybe_initialize(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize ``jax.distributed`` if configured; returns True when a
    multi-process runtime is (already) up. Safe to call more than once."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator = coordinator or os.environ.get("CMSBWT_COORDINATOR")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["CMSBWT_NUM_PROCESSES"])
        if "CMSBWT_NUM_PROCESSES" in os.environ else None)
    process_id = process_id if process_id is not None else (
        int(os.environ["CMSBWT_PROCESS_ID"])
        if "CMSBWT_PROCESS_ID" in os.environ else None)
    if coordinator is None and num_processes is None:
        return False
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    _INITIALIZED = True
    return True


def process_index() -> int:
    import jax
    return jax.process_index()


def is_primary() -> bool:
    return process_index() == 0
