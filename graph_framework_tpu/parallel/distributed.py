"""Multi-host initialization and per-host sharded output.

The reference is strictly single-node (SURVEY.md section 2.6: std::thread
per device, no MPI/NCCL anywhere); multi-host is new capability here.
One call sets up the jax.distributed runtime; the same SPMD trace code
then spans all hosts, with the ray axis sharded over every device and the
only collective (the Newton ensemble-max) an all-reduce.

Output follows the reference's file-per-worker scheme (result<n>.nc per
device thread, xrays.cpp:461): each host writes the rows of its addressable
shards to ``result<process_index>.nc``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime (no-op if single-process).

    With no arguments, jax.distributed auto-detects a cluster environment
    it knows; elsewhere pass coordinator_address, num_processes and
    process_id explicitly.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def process_info():
    """(process_index, process_count, local_device_count)."""
    return (jax.process_index(), jax.process_count(),
            jax.local_device_count())


def host_local_rows(array) -> tuple[np.ndarray, np.ndarray]:
    """Fetch the rows of a ray-sharded array owned by this host.

    Returns (global_indices, values); together with a per-host ResultFile
    (``result<process_index>.nc``) this reproduces the reference's
    shard-per-file output layout without any cross-host gather.
    """
    idx_chunks = []
    val_chunks = []
    for shard in array.addressable_shards:
        sl = shard.index[0]
        start = sl.start or 0
        data = np.asarray(shard.data)
        idx_chunks.append(np.arange(start, start + data.shape[0]))
        val_chunks.append(data)
    if not idx_chunks:
        return np.empty(0, dtype=np.int64), np.empty(0)
    return np.concatenate(idx_chunks), np.concatenate(val_chunks)


def host_output_filename(base: str = "result") -> str:
    """result<process_index>.nc (xrays.cpp:461 naming)."""
    return f"{base}{jax.process_index()}.nc"
