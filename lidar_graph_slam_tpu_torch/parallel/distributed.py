"""Mesh parallelism: the slot mesh, batched registration, the distributed graph step.

Port of `lidar_graph_slam_tpu/parallel/distributed.py`. The reference's `jax.sharding.Mesh`
is a single-controller object whose `shard_map` programs run once per device with
collectives between them. Here a `Mesh` is a tuple of slot devices, and a shard program
is a Python loop over the slots, each slot's part on its own device, joined by explicit
collectives:

  * `psum`: the slots' partials summed in a fixed order (slot 0 first) on slot 0's
    device, then placed on every slot — deterministic, no float atomics;
  * `ppermute`: a rotation of the per-slot list (slot i's value to slot i + 1);
  * the slot number, the reference's `axis_index`, is the loop index.

The slots run one after another from one host thread, so several slots on one device
(`Mesh((cuda:0,) * 4)`, or the CPU mesh of the tests) compute the same decomposition as
as many cards would, without their parallel speed. `make_mesh` gives n slots on the CPU
(the counterpart of the reference tests' 8 virtual devices) or the visible cards.

Under a process group of more than one process (`parallel/multihost.py`), `make_mesh` spans
every process's slots in process order, as the reference's `jax.devices()` does, and
`Mesh.owners` names the process of each slot. A shard program then runs only this
process's slots; `all_slots` all-gathers every slot's value as host tensors (gloo), and
`psum` / `ppermute` work on the gathered values in slot order, so every process holds the
same bits, equal to those of a one-process mesh of as many slots. Every process must
issue the same collectives in the same order.

  * **Batched registration** (`batched_icp`, `batched_ndt`): a [B, N, 3] batch of sources
    against one shared target, the batch split over the slots.
  * **Distributed pose-graph step** (`distributed_graph_step`): each slot linearizes its
    shard of the odometry chain, the block systems are `psum`-reduced, and the
    tridiagonal solve with the loop factors (Woodbury) runs once on the reduced system.
  * `mesh_optimize`: Levenberg-Marquardt whose steps are the Schur-decomposed
    (`parallel/schur.py`) or the chain steps; `shard_batch` lays a verification batch out
    over the slots.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.core.device import resolve_device
from lidar_graph_slam_tpu_torch.graph import solver as gsolver
from lidar_graph_slam_tpu_torch.ops.kernels import stack_maps
from lidar_graph_slam_tpu_torch.registration.base import RegistrationResult
from lidar_graph_slam_tpu_torch.registration.icp import icp_align
from lidar_graph_slam_tpu_torch.registration.ndt import ndt_align_batched


def process_count() -> int:
    """Processes in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of slots: `devices[i]` runs slot i's part of a shard program.
    Several slots may share a device. `owners[i]` is the process that runs slot i (empty:
    this process runs every slot); a mesh that spans processes gives each the same
    number of slots, in process order."""

    devices: tuple
    axis: str = "scan"
    owners: tuple = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_slots(self) -> tuple:
        """The slots this process runs, in slot order."""
        if not self.owners:
            return tuple(range(self.size))
        rank = process_index()
        return tuple(i for i, p in enumerate(self.owners) if p == rank)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.owners)) > 1


def _local_devices(n_devices: int | None, device) -> tuple:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return tuple(cards[: n_devices or len(cards)])


def make_mesh(n_devices: int | None = None, axis: str = "scan", device=None) -> Mesh:
    """`n_devices` slots: on the CPU (`device="cpu"`) n slots on the CPU (1 when None);
    on CUDA the visible cards, the first `n_devices` of them (all when None).

    Under a process group of more than one process the mesh spans them all: each process
    contributes `n_devices / processes` slots built as above (its default when None),
    joined by `span_processes` — a collective, so every process calls it together."""
    n_proc = process_count()
    if n_proc <= 1:
        return Mesh(_local_devices(n_devices, device), axis)
    if n_devices is not None and n_devices % n_proc:
        raise ValueError(f"a mesh of {n_devices} slots does not divide over {n_proc} "
                         f"processes")
    return span_processes(_local_devices(n_devices // n_proc if n_devices else None, device),
                          axis)


def span_processes(local_devices: tuple, axis: str = "scan") -> Mesh:
    """One mesh over every process's `local_devices` (this process's slots, e.g. two slots
    of one card), in process order: the slot lists are all-gathered, so every process
    calls it together, each with as many slots."""
    per_process = [None] * process_count()
    dist.all_gather_object(per_process, [str(d) for d in local_devices])
    if len({len(p) for p in per_process}) != 1:
        raise ValueError(f"processes contribute unequal slot counts: "
                         f"{[len(p) for p in per_process]}")
    return Mesh(tuple(torch.device(d) for p in per_process for d in p), axis,
                tuple(r for r, p in enumerate(per_process) for _ in p))


# --- collectives and placement -----------------------------------------------------------


def tree_to(x, device):
    """`x` with every tensor moved to `device` (tensors, dataclasses, tuples, lists, dicts;
    anything else as it is). A tensor already there is not copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: tree_to(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (tuple, list)):
        return type(x)(tree_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x


def all_gather_host(t: torch.Tensor) -> list:
    """Every process's `t` (one shape and dtype on all of them) as CPU tensors, in rank
    order: one all-gather of host tensors. A collective: every process calls it."""
    t = t.detach().cpu().contiguous()
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) if f.init
                for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rebuild(tree, leaves):
    """`tree` with its tensor leaves taken in order from the iterator `leaves`."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return tree


def all_slots(mesh: Mesh, local: list) -> list:
    """Every slot's value, in slot order, from this process's slots' values (`local`, one
    tree a slot in `mesh.local_slots` order; tensors, tuples, lists, dataclasses). On a
    mesh that spans processes every tensor leaf is all-gathered as host tensors, so the
    trees must have one structure and shape a slot; a collective then. Otherwise `local`
    is every slot's already."""
    if not mesh.spans_processes:
        return list(local)
    per_slot = [_leaves(t) for t in local]
    gathered = [torch.cat(all_gather_host(torch.stack([ls[j].cpu() for ls in per_slot])))
                for j in range(len(per_slot[0]))]
    return [_rebuild(local[0], iter([g[i] for g in gathered])) for i in range(mesh.size)]


def psum(mesh: Mesh, parts: list) -> list:
    """The slots' partials (one tensor, or tuple of tensors, a local slot) summed slot 0
    first, on the device of this process's first slot; returns one copy per local slot
    on its device. On a mesh that spans processes every slot's partial is all-gathered
    first (`all_slots`), so every process sums the same values in the same order: the
    sums are bit-equal on every process and to a one-process mesh of as many slots."""
    local = mesh.local_slots
    parts = all_slots(mesh, parts)
    dev0 = mesh.devices[local[0]]

    def total(xs):
        acc = xs[0].to(dev0)
        for x in xs[1:]:
            acc = acc + x.to(dev0)
        return acc

    if isinstance(parts[0], tuple):
        summed = tuple(total(list(xs)) for xs in zip(*parts))
    else:
        summed = total(parts)
    return [tree_to(summed, mesh.devices[i]) for i in local]


def ppermute(mesh: Mesh, values: list) -> list:
    """Rotation by one slot: slot i's value arrives at slot (i + 1) % n. `values` holds
    one tensor a local slot; returns the local slots' arrivals."""
    values = all_slots(mesh, values)
    n = mesh.size
    return [values[(i - 1) % n].to(mesh.devices[i]) for i in mesh.local_slots]


def _split(mesh: Mesh, batch: int) -> int:
    """Items per slot of a batch split over the mesh; the batch must divide the mesh (the
    reference's sharded inputs must)."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not divide the mesh's {mesh.size} slots")
    return batch // mesh.size


def _stack_results(results: list, device) -> RegistrationResult:
    return RegistrationResult(**{f.name: torch.cat([getattr(r, f.name).to(device)
                                                    for r in results])
                                 for f in dataclasses.fields(RegistrationResult)})


# --- batched registration over the mesh -------------------------------------------------


def batched_icp(mesh: Mesh, target_grid, sources, masks, init_Ts, **kw) -> RegistrationResult:
    """Align a [B, N, 3] batch of sources against one shared target grid, the batch split
    over the slots (each local slot's sources one after another with `icp_align`; the
    slots' results gathered with `all_slots`). Returns a `RegistrationResult` with
    leading axis B, on the sources' device."""
    per = _split(mesh, sources.shape[0])
    out = []
    for s in mesh.local_slots:
        dev = mesh.devices[s]
        grid = tree_to(target_grid, dev)
        items = []
        for i in range(s * per, (s + 1) * per):
            r = icp_align(grid, sources[i].to(dev), masks[i].to(dev), init_Ts[i].to(dev), **kw)
            items.append(RegistrationResult(**{f.name: getattr(r, f.name)[None] for f in
                                               dataclasses.fields(RegistrationResult)}))
        out.append(_stack_results(items, dev))
    return _stack_results(all_slots(mesh, out), sources.device)


def batched_ndt(mesh: Mesh, vmap_target, sources, masks, init_Ts, **kw) -> RegistrationResult:
    """`batched_icp` for NDT against a shared voxel map: each local slot aligns its part of
    the batch at once with `ndt_align_batched` (one batched kernel launch per
    iteration, no host read)."""
    per = _split(mesh, sources.shape[0])
    out = []
    for s in mesh.local_slots:
        dev = mesh.devices[s]
        lo, hi = s * per, (s + 1) * per
        vm = stack_maps([tree_to(vmap_target, dev)] * per)
        out.append(ndt_align_batched(vm, sources[lo:hi].to(dev), masks[lo:hi].to(dev),
                                     init_Ts[lo:hi].to(dev), **kw))
    return _stack_results(all_slots(mesh, out), sources.device)


# --- distributed pose-graph step --------------------------------------------------------


def _local_chain_blocks(poses, odom_meas, pose_mask, info, lo: int, length: int, K: int):
    """Linearize chain factors [lo, lo+length) into full-size (D, U, b) with zeros
    elsewhere. Factor k is the between-factor (k-1 -> k), k >= 1; each pose index takes
    at most one term of each kind, as in the reference's scatter-adds."""
    dtype, dev = poses.dtype, poses.device
    D = torch.zeros((K, 6, 6), dtype=dtype, device=dev)
    U = torch.zeros((K - 1, 6, 6), dtype=dtype, device=dev)
    b = torch.zeros((K, 6), dtype=dtype, device=dev)
    k0, k1 = max(lo, 1), min(lo + length, K)
    if k0 >= k1:
        return D, U, b
    Ti, Tj, Z = poses[k0 - 1:k1 - 1], poses[k0:k1], odom_meas[k0:k1]
    r, Ji, Jj = gsolver.between_residual(Ti, Tj, Z)
    m = (pose_mask[k0 - 1:k1 - 1] & pose_mask[k0:k1]).to(dtype)[:, None, None]
    JiW = Ji.transpose(-1, -2) * info[None, None, :]
    JjW = Jj.transpose(-1, -2) * info[None, None, :]
    D[k0 - 1:k1 - 1] += m * (JiW @ Ji)
    D[k0:k1] += m * (JjW @ Jj)
    U[k0 - 1:k1 - 1] += m * (JiW @ Jj)
    b[k0 - 1:k1 - 1] += -(m[..., 0] * (JiW @ r[..., None])[..., 0])
    b[k0:k1] += -(m[..., 0] * (JjW @ r[..., None])[..., 0])
    return D, U, b


def distributed_graph_step(mesh: Mesh, g: gsolver.PoseGraph, damping=1e-4) -> torch.Tensor:
    """One distributed damped-GN step on the pose graph: each slot linearizes its shard of
    the odometry chain, the block systems are `psum`-reduced, and the prior, masking,
    damping and the tridiagonal solve with the loop factors run once on the reduced
    system (on every process of a mesh that spans processes, on bit-equal values).
    Returns the updated poses [K, 4, 4] on the graph's device."""
    K = g.poses.shape[0]
    shard = -(-K // mesh.size)  # factors per slot (ceil)
    parts = []
    for idx in mesh.local_slots:
        gd = tree_to(g, mesh.devices[idx])
        parts.append(_local_chain_blocks(gd.poses, gd.odom_meas, gd.pose_mask,
                                         gd.odom_info, idx * shard, shard, K))
    D, U, b = psum(mesh, parts)[0]
    g0 = tree_to(g, mesh.devices[mesh.local_slots[0]])
    dtype = g0.poses.dtype
    # Prior factor + masking + damping (replicated in the reference, once here).
    r0 = se3.se3_log(se3.inverse(g0.prior_pose) @ g0.poses[0])
    J0 = gsolver._jr_inv(r0)
    J0W = J0.transpose(-1, -2) * g0.odom_info[None, :]
    D[0] += J0W @ J0
    b[0] += -(J0W @ r0[:, None])[:, 0]
    active = g0.pose_mask.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=D.device)
    D = active[:, None, None] * D + (1.0 - active)[:, None, None] * eye6
    D = D + torch.as_tensor(damping, dtype=dtype, device=D.device) * active[:, None, None] * eye6
    b = active[:, None] * b
    delta = _woodbury_solve(g0, D, U, b)
    poses = g0.poses @ se3.se3_exp(torch.where(torch.isfinite(delta), delta, 0.0))
    return poses.to(g.poses.device)


def _woodbury_solve(g: gsolver.PoseGraph, D, U, b) -> torch.Tensor:
    """Shared tail of the solve: fold loop factors into the tridiagonal system."""
    b_loop, Vw = gsolver.loop_gradient_and_whitened_columns(g, g.poses)
    rhs = torch.cat([(b + b_loop)[..., None], Vw], dim=-1)
    sol = gsolver._tridiag_solve(D, U, rhs)
    return gsolver.woodbury_correct(Vw, sol[..., 0], sol[..., 1:])


# --- mesh-distributed LM optimize (the back end's device solve path) -----------------------


def _step_norm(poses, cand) -> torch.Tensor:
    """Max twist norm of the proposed step (right perturbation poses -> cand)."""
    xi = se3.se3_log(se3.inverse(poses) @ cand)
    return torch.max(torch.sqrt(torch.sum(xi * xi, dim=-1)))


def mesh_optimize(mesh: Mesh, g: gsolver.PoseGraph, max_iterations: int = 15,
                  init_damping: float = 1e-4, solver: str = "schur") -> gsolver.PoseGraph:
    """Levenberg-Marquardt over the pose graph with each GN step distributed over the
    mesh: domain-decomposed (`solver="schur"`, `parallel/schur.py`) or with the sharded
    chain linearization (`solver="chain"`). The damping schedule and the masked
    accept/reject are `graph/solver.py:optimize`'s, decided on the host from one read of
    three scalars per iteration, as in the reference."""
    from lidar_graph_slam_tpu_torch.parallel import schur as schur_mod

    if solver == "schur":
        step = lambda gg, d: schur_mod.schur_graph_step(mesh, gg, d)  # noqa: E731
    elif solver == "chain":
        step = lambda gg, d: distributed_graph_step(mesh, gg, d)      # noqa: E731
    else:
        raise ValueError(f"unknown mesh solver {solver!r}")

    poses = g.poses
    damping = float(init_damping)
    for _ in range(max_iterations):
        cand = step(g.replace(poses=poses), damping)
        cost0, cost1, step_norm = torch.stack([
            gsolver.graph_cost(g, poses), gsolver.graph_cost(g, cand),
            _step_norm(poses, cand)]).tolist()
        accept = np.isfinite(cost1) and cost1 < cost0
        # Plateau only on ACCEPTED steps; a REJECTED sub-millimeter step is the f32
        # floor (stuck).
        if accept:
            poses = cand
            if abs(cost0 - cost1) < 1e-5 * max(cost0, 1e-3):
                break
            damping = max(damping * 0.3, 1e-9)
        else:
            if step_norm < gsolver._STUCK_STEP_TOL:
                break
            damping = min(damping * 8.0, 1e6)
    return g.replace(poses=poses)


# --- batched top-k loop verification -----------------------------------------------------


def stack_pytrees(trees):
    """Stack a list of identically-shaped trees (tensors, dataclasses, tuples) along a new
    leading batch axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack_pytrees([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, (tuple, list)):
        return type(first)(stack_pytrees(list(xs)) for xs in zip(*trees))
    return first


def shard_batch(mesh: Mesh, batched: list, shared):
    """Lay a verification batch out on the mesh: `batched` holds one tree per item (the
    batch axis), `shared` the tree every item reads. When the batch divides the mesh,
    item i goes to slot i // (batch / n)'s device with a copy of `shared` there; a batch
    that does not divide it is left where it is (a sub-mesh batch gains nothing). On a
    mesh that spans processes the items of another process's slots are left where they
    are too: that process verifies them (`gather_slot_items` brings their results).
    Returns (items, shared per item, slot per item — None when left alone)."""
    n = mesh.size
    if len(batched) % n:
        return list(batched), [shared] * len(batched), [None] * len(batched)
    per = len(batched) // n
    local = set(mesh.local_slots)
    copies = {}
    items, shares, slots = [], [], []
    for i, item in enumerate(batched):
        s = i // per
        slots.append(s)
        if s not in local:
            items.append(item)
            shares.append(shared)
            continue
        dev = mesh.devices[s]
        if dev not in copies:
            copies[dev] = tree_to(shared, dev)
        items.append(tree_to(item, dev))
        shares.append(copies[dev])
    return items, shares, slots


def gather_slot_items(mesh: Mesh, slots: list, local_results: dict) -> list:
    """The results of a batch laid out by `shard_batch`, in item order: `local_results`
    maps each item of this process's slots to its result (a tree of host tensors of one
    shape an item); on a mesh that spans processes the other slots' results are
    all-gathered (`all_slots`), otherwise every item is local already."""
    if not mesh.spans_processes or slots[0] is None:
        return [local_results[i] for i in range(len(slots))]
    per = len(slots) // mesh.size
    by_slot = [stack_pytrees([local_results[i] for i in range(s * per, (s + 1) * per)])
               for s in mesh.local_slots]
    items = []
    for tree in all_slots(mesh, by_slot):  # each leaf stacked [per, ...]
        leaves = _leaves(tree)
        items += [_rebuild(tree, iter([leaf[k] for leaf in leaves])) for k in range(per)]
    return items
