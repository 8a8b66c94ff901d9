"""Multi-host (multi-process) distribution.

The reference is a single-device macOS app (SURVEY §2.4 — no distribution of
any kind), so this layer is new design.  It follows the standard JAX
single-controller-per-process model:

  * every process calls :func:`initialize` (``jax.distributed.initialize``)
    and then sees the GLOBAL device set; the (data, tile) mesh from
    ``sharding.make_mesh`` spans all hosts, with the "data" axis laid out so
    consecutive data-shards stay on one host's local devices (the gradient
    all-reduce crosses between hosts only once per ring).
  * each process loads ONLY its own slice of the camera views
    (:func:`local_view_range`) — images for other hosts' cameras never touch
    this host's RAM or NICs.
  * each training step, every process materializes the per-step view batch
    for ITS addressable data-shards only; :func:`make_global_view_batch`
    assembles the global [data_parallel, ...] arrays from the process-local
    pieces (``jax.make_array_from_process_local_data``).  The batched DP
    train step (``sharding.make_dp_train_step(batched_views=True)``)
    consumes them; camera pixels never cross hosts — only the replicated
    parameter gradients do, inside the step's ``pmean``.

Single-process use degenerates cleanly: ``initialize()`` is a no-op without a
coordinator, ``local_view_range`` returns the full range, and
``make_global_view_batch`` is an ordinary device_put with a "data" sharding —
so every code path here is exercised by the virtual-device tests and the
driver dry-run, and scales unchanged to a real cluster
(``scripts/launch_multihost.py`` runs the genuinely multi-process form).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join (or start) the distributed runtime.

    Arguments fall back to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) used by
    ``scripts/launch_multihost.py``.  A plain single-process run (no
    coordinator anywhere) is a no-op.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process: nothing to join
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def local_view_range(
    num_views: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """Global view indices this process is responsible for loading.

    Contiguous block partition, padded by wrap-around so every process owns
    the same count (keeps per-step batch shapes identical across hosts).
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = -(-num_views // pc)  # ceil
    return (np.arange(pi * per, (pi + 1) * per) % num_views).astype(np.int64)


def data_process_mesh(
    mesh_or_none=None,
    tile_parallel: int = 1,
) -> Mesh:
    """(data, tile) mesh with host-contiguous data-shards.

    ``jax.devices()`` orders devices by process, so a row-major reshape keeps
    each host's devices adjacent along "data": the gradient ``pmean`` forms
    a ring whose intra-host hops stay on the host's interconnect and which
    crosses between hosts once per host boundary, not once per device.
    """
    from . import sharding

    return sharding.make_mesh(0, tile_parallel)


def local_data_shards(mesh: Mesh) -> Tuple[np.ndarray, int]:
    """(positions, count): which "data" coordinates live on this process."""
    axes = list(mesh.axis_names)
    di = axes.index("data")
    dev_grid = np.asarray(mesh.devices)
    # data coordinate of each device in the grid
    pos = []
    it = np.nditer(np.zeros(dev_grid.shape), flags=["multi_index"])
    for _ in it:
        d = dev_grid[it.multi_index]
        if d.process_index == jax.process_index():
            pos.append(it.multi_index[di])
    pos = np.unique(np.asarray(pos, np.int64))
    return pos, len(pos)


def make_global_view_batch(
    local_batch: Dict[str, np.ndarray], mesh: Mesh
) -> Dict[str, jax.Array]:
    """Per-process [local_data, ...] arrays -> global [data_parallel, ...]
    jax.Arrays sharded P("data", None, ...).

    ``local_batch[k][i]`` must be the tensors for the i-th data-shard owned
    by THIS process (in ``local_data_shards`` order).  Single-process this is
    just a device_put with the "data" sharding.
    """
    out = {}
    for k, v in local_batch.items():
        v = np.asarray(v)
        spec = P("data", *([None] * (v.ndim - 1)))
        sharding_ = NamedSharding(mesh, spec)
        if jax.process_count() == 1:
            out[k] = jax.device_put(v, sharding_)
        else:
            global_shape = (mesh.shape["data"],) + v.shape[1:]
            out[k] = jax.make_array_from_process_local_data(
                sharding_, v, global_shape
            )
    return out


def select_local_batch(
    views: Dict[str, np.ndarray],
    local_views: np.ndarray,
    chosen: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Assemble this process's per-step batch from its host-local view store.

    ``views`` holds ONLY this host's cameras (stacked, in ``local_views``
    order); ``chosen`` gives, per local data-shard, the GLOBAL view id drawn
    for this step (must be one of ``local_views``).
    """
    lookup = {int(g): i for i, g in enumerate(local_views)}
    rows = np.asarray([lookup[int(c)] for c in chosen], np.int64)
    return {k: np.asarray(v)[rows] for k, v in views.items()}


def sample_local_view_ids(
    rng: np.random.Generator, local_views: np.ndarray, n_shards: int
) -> np.ndarray:
    """Draw one host-local GLOBAL view id per local data-shard.

    Sampling host-locally (rather than globally) keeps every target fetch on
    this host; with shuffled camera-to-host assignment this matches the
    reference's uniform random camera schedule in distribution
    (GaussianTrainer.swift random view pick per step).
    """
    return local_views[rng.integers(0, len(local_views), size=n_shards)]
