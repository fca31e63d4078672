"""Multi-process initialisation for runs that span several hosts.

The reference has no distributed backend (SURVEY §2.3); this build's
scale-out is JAX-native: initialise the distributed runtime once per
process, then `make_mesh()` sees every GPU of every process and the
sharded quasimap (`mesh.py`) runs data-parallel with psum coverage
merges (NCCL) without further code changes.

Typical launch (same command in every process, one process per host):

    from gramtools_tpu.parallel.distributed import init_distributed
    init_distributed("host0:12345", num_processes=2, process_id=rank)
    mesh = make_mesh()             # all GPUs of all processes
    ... MeshLogEngine(idx, k, mesh=mesh)

After the mapping + psum pass, every host holds the globally-reduced
coverage; rank 0 runs the (host-side) genotyping + output phase, which
is the reference's single-process inference stage unchanged.
"""
from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger("gramtools_tpu")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """jax.distributed.initialize with an explicit topology. On a plain
    GPU host nothing describes the cluster, so pass all three arguments;
    under a cluster manager JAX can discover them from its environment."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
        log.info("distributed runtime: process %d of %d",
                 jax.process_index(), jax.process_count())
    except (RuntimeError, ValueError) as e:
        log.warning("jax.distributed.initialize failed/skipped: %s", e)


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
