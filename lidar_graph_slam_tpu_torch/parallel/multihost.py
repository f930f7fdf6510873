"""Multi-process operation: the process group, meshes that span processes, and a keyframe
store sharded over the processes.

Port of `lidar_graph_slam_tpu/parallel/multihost.py`. A multi-host deployment is N
identical SPMD processes fed the same scan stream:

  * `initialize_from_env()` — `torch.distributed.init_process_group` (gloo) from the
    `LGS_COORDINATOR` / `LGS_NUM_PROCESSES` / `LGS_PROCESS_ID` variables, with a finite
    timeout, so a missing peer fails instead of hanging. Gloo moves host tensors, which is
    what the store's gathers and the mesh collectives carry, and it runs several ranks
    on one card (NCCL refuses two ranks on one device).
  * `make_global_mesh()` — one `parallel/distributed.py:Mesh` over every process's slots;
    the mesh paths (`parallel/schur.py`, `parallel/distributed.py`,
    `GraphBasedSLAM(mesh=...)`) run on it: each process runs its slots and the
    collectives all-gather in slot order, so every process holds the same bits.
  * `HostShardedKeyframeStore` — keyframe clouds partitioned round-robin over the
    processes (each keeps only the clouds it owns); poses and metadata replicate. A
    submap read is a two-phase all-gather (counts, then blocks padded to the window's
    largest cloud) — the only bulk transfer between processes.

Every process must make the same calls in the same order: the back end runs its
verification and solve inline when there is more than one process
(`graph/slam.py:GraphBasedSLAM.async_enabled`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from lidar_graph_slam_tpu_torch.parallel.distributed import (
    Mesh,
    all_gather_host,
    make_mesh,
    process_count,
    process_index,
    tree_to,
)

# A peer that never joins (or a collective it never issues) fails after this long:
# `jax.distributed.initialize`'s own default.
PROCESS_GROUP_TIMEOUT_S = 300


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group from the arguments or the `LGS_COORDINATOR` (host:port of
    process 0) / `LGS_NUM_PROCESSES` / `LGS_PROCESS_ID` variables. Returns True when a
    process group of more than one process was formed, False for single-process operation
    (no coordinator, or at most one process). Raises ValueError when the count is > 1 and
    the id is missing, and whatever `init_process_group` raises when the group cannot form:
    a configured run never carries on alone. Call once per process, before any mesh."""
    coordinator_address = coordinator_address or os.environ.get("LGS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("LGS_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("LGS_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None
    if not coordinator_address or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("LGS_PROCESS_ID required when LGS_NUM_PROCESSES > 1")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return True


def make_global_mesh(axis: str = "scan", n_local: Optional[int] = None, device=None) -> Mesh:
    """One mesh over every process's slots, in process order; each process contributes
    `make_mesh`'s slots: `n_local` CPU slots (`device="cpu"`, 1 when None) or its visible
    cards. After `initialize_from_env` the mesh's collectives cross processes. A
    collective: every process calls it together."""
    return make_mesh(n_local * process_count() if n_local else None, axis, device)


def replicate_to_mesh(tree, mesh: Mesh):
    """Identical process-local values (every process passes the same, SPMD) as this
    process's copy for the mesh: on the device of its first slot. The hand-off that lets
    single-process state (a `PoseGraph`) enter a computation over the whole mesh; the
    shard programs place it on each of their slots' devices."""
    return tree_to(tree, mesh.devices[mesh.local_slots[0]])


def fetch_replicated(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """A value the mesh's programs leave identical on every process (a mesh step's
    poses: every process solves the same gathered system) as host numpy, on every
    process. No transfer between processes is needed: the collectives ran inside the
    step."""
    return x.detach().cpu().numpy()


def _process_allgather(x: np.ndarray) -> np.ndarray:
    """[n_proc, *x.shape]: every process's `x` (one shape on all), in rank order."""
    return torch.stack(all_gather_host(torch.from_numpy(np.ascontiguousarray(x)))).numpy()


class HostShardedKeyframeStore:
    """Keyframe clouds partitioned by process; poses replicated.

    Ownership is round-robin over process ids (balances a live keyframe stream without
    coordination). Every process calls `add` for every keyframe — non-owners record only
    the metadata. `assemble_submap` returns the map-frame concatenation of a keyframe
    range, fetching other processes' clouds through a two-phase all-gather; with one
    process it is the plain local concatenation.
    """

    def __init__(self, pad_points: int = 16384,
                 process_id: Optional[int] = None, num_processes: Optional[int] = None):
        self.pad_points = pad_points
        self.pid = process_index() if process_id is None else process_id
        self.n_proc = process_count() if num_processes is None else num_processes
        self._clouds: dict[int, np.ndarray] = {}  # only the keyframes this process owns
        self.n_keyframes = 0

    def owner(self, k: int) -> int:
        return k % self.n_proc

    def owns(self, k: int) -> bool:
        return self.owner(k) == self.pid

    def add(self, k: int, cloud: Optional[np.ndarray]) -> None:
        """Register keyframe k; stores the cloud only on the owning process. Non-owners may
        pass None (the cloud need not reach them)."""
        if self.owns(k):
            if cloud is None:
                raise ValueError(f"process {self.pid} owns keyframe {k}: cloud required")
            self._clouds[k] = np.asarray(cloud, dtype=np.float32)
        self.n_keyframes = max(self.n_keyframes, k + 1)

    def local_ids(self) -> list:
        return sorted(self._clouds)

    def get_cloud(self, k: int) -> np.ndarray:
        """Keyframe k's raw (sensor/base-frame) cloud on EVERY process — one padded
        all-gather (all processes call together)."""
        poses = np.tile(np.eye(4, dtype=np.float32)[None], (k + 1, 1, 1))
        return self.assemble_submap(k, k + 1, poses)

    def assemble_submap(self, lo: int, hi: int, poses: np.ndarray) -> np.ndarray:
        """Map-frame concatenation of keyframes [lo, hi) under `poses` [K, 4, 4]
        (replicated), in keyframe order.

        Each process transforms the clouds it owns (`cloud @ R.T + t` in float32 numpy, as
        the back end's local path does); one all-gather of the count vector sizes the
        blocks to the window's LARGEST cloud (capped at `pad_points`), then one block
        all-gather merges them: every process receives the same submap (all processes
        call this together)."""
        ids = list(range(lo, hi))
        transformed = {}
        local_count = np.zeros((len(ids),), np.int32)
        for row, k in enumerate(ids):
            if self.owns(k) and k in self._clouds:
                T = poses[k]
                pts = self._clouds[k] @ T[:3, :3].T + T[:3, 3]
                transformed[row] = pts[: self.pad_points]
                local_count[row] = transformed[row].shape[0]
        if self.n_proc <= 1:
            counts = local_count[None]
        else:
            # Two-phase gather: the count vector first, then blocks padded only to the
            # window's largest cloud, so the bytes track the clouds.
            counts = _process_allgather(local_count)
        pad_to = int(counts.max()) if counts.size else 0
        local_block = np.zeros((len(ids), max(pad_to, 1), 3), np.float32)
        for row, pts in transformed.items():
            local_block[row, : pts.shape[0]] = pts
        blocks = local_block[None] if self.n_proc <= 1 else _process_allgather(local_block)
        chunks = []
        for row, k in enumerate(ids):
            p = self.owner(k)
            n = int(counts[p, row])
            if n:
                chunks.append(blocks[p, row, :n])
        if not chunks:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(chunks).astype(np.float32)
