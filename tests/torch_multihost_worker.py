"""One process of the port's two-process runs (`tests/test_torch_multihost.py`): joins the
process group from `LGS_*`, runs the named phases on the CPU, and writes what each phase
computed to `<out_dir>/p<rank>.npz` for the parent to compare. Imports torch and the port
only; the parent holds the JAX package's outputs against these.

Run: python torch_multihost_worker.py <port> <process_id> <out_dir> <phase> [<phase> ...]
Phases: `core` (global mesh, sharded store, the chain and Schur steps), `pipeline` (a short
sharded `SlamPipeline`), `mesh` (`parallel.use_mesh` pipeline and a two-slot top-k loop
attempt over the processes), `course` (the 75-frame loop course of the reference worker).
Prints TORCH_MULTIHOST_OK as its last line on success.
"""

import os
import sys

port, pid, out_dir, phases = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4:]
os.environ["LGS_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["LGS_NUM_PROCESSES"] = "2"
os.environ["LGS_PROCESS_ID"] = str(pid)
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# One intra-op thread: several of these processes share the host with other test workers.
torch.set_num_threads(1)

from lidar_graph_slam_tpu_torch.parallel import distributed as tdist  # noqa: E402
from lidar_graph_slam_tpu_torch.parallel import multihost  # noqa: E402
from tests import torch_multihost_fixtures as fx  # noqa: E402

assert multihost.initialize_from_env(), "expected multi-process initialization"
assert tdist.process_count() == 2 and tdist.process_index() == pid
out = {}


def core():
    """A 4-slot global mesh (2 CPU slots a process), the sharded store on the reference
    worker's fixture, and the chain and Schur steps on its K = 16 graph."""
    from lidar_graph_slam_tpu_torch.parallel.distributed import distributed_graph_step
    from lidar_graph_slam_tpu_torch.parallel.schur import schur_graph_step

    mesh = multihost.make_global_mesh(n_local=2, device="cpu")
    assert mesh.size == 4 and mesh.owners == (0, 0, 1, 1), mesh
    assert mesh.local_slots == ((0, 1) if pid == 0 else (2, 3))
    store = multihost.HostShardedKeyframeStore(pad_points=64)
    clouds, poses, rng = fx.store_fixture()
    for k in range(len(clouds)):
        store.add(k, clouds[k] if store.owns(k) else None)
    out["store_local_ids"] = np.asarray(store.local_ids())
    out["submap"] = store.assemble_submap(0, 6, poses)
    out["cloud3"] = store.get_cloud(3)
    g = multihost.replicate_to_mesh(fx.torch_graph(rng), mesh)
    out["chain"] = multihost.fetch_replicated(distributed_graph_step(mesh, g, 1e-4), mesh)
    out["schur"] = multihost.fetch_replicated(schur_graph_step(mesh, g, 1e-4), mesh)


def pipeline():
    """A short sharded `SlamPipeline` (the default asynchronous back end, forced off)."""
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline

    pipe = SlamPipeline(fx.small_config(), device="cpu")
    store = pipe.back.cloud_store
    assert store is not None and store.n_proc == 2, "a multi-process run shards its clouds"
    assert not pipe.back.async_enabled
    res = pipe.run(fx.short_scans())
    out["pipe_keyframe_poses"] = res.keyframe_poses
    out["pipe_odometry_poses"] = res.odometry_poses
    out["pipe_owned"] = np.asarray(store.local_ids())
    out["pipe_map"] = pipe.back.assemble_map(0.5)
    from lidar_graph_slam_tpu_torch.utils.checkpoint import save_pipeline

    try:
        save_pipeline(pipe, os.path.join(out_dir, f"refused-{pid}.npz"))
    except NotImplementedError:
        out["save_refused"] = np.asarray(True)


def mesh():
    """`parallel.use_mesh` with 4 slots over the two processes; on a 2-slot global mesh
    (one slot a process) `batch_odometry` on two sequences, a top-2 loop attempt (one
    candidate a process) through the sharded store, and the mesh LM of its escalation
    ladder."""
    from lidar_graph_slam_tpu_torch.parallel.multi_sequence import batch_odometry
    from lidar_graph_slam_tpu_torch.parallel.multihost import HostShardedKeyframeStore
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline

    pipe = SlamPipeline(fx.small_config(use_mesh=True, mesh_devices=4), device="cpu")
    assert pipe.back.mesh.size == 4 and pipe.back.mesh.spans_processes
    res = pipe.run(fx.short_scans(5))
    out["mesh_pipe_keyframe_poses"] = res.keyframe_poses
    mesh = multihost.make_global_mesh(n_local=1, device="cpu")
    scans, masks, cfg = fx.batch_course()
    final, outs = batch_odometry(scans, masks, cfg, map_capacity=4096, mesh=mesh)
    out["batch_pose"], out["batch_ring"] = outs["pose"].numpy(), final.ring_clouds.numpy()
    back = fx.multi_lap_backend(mesh=mesh, cloud_store=HostShardedKeyframeStore(4096))
    assert back.try_close_loop()
    log = [(r["candidate"], r["accepted"], r["fitness"]) for r in back.loop_log]
    out["topk_log"] = np.asarray(log, np.float64)
    out["topk_poses"] = back.optimized_poses()
    gb = back._bucket_graph()
    out["topk_device_lm"] = back._make_device_lm(gb)(back._host_view().poses)


def course():
    """The reference worker's pipeline phase (`tests/multihost_worker.py:105-141`)."""
    from lidar_graph_slam_tpu_torch.pipeline.runner import SlamPipeline

    pipe = SlamPipeline(fx.small_config(), device="cpu")
    res = pipe.run(fx.course_scans())
    out["course_keyframe_poses"] = res.keyframe_poses
    out["course_loops"] = np.asarray(res.num_loop_closures)
    out["course_decisions"] = np.asarray([(r["candidate"], r["accepted"])
                                          for r in res.loop_log], np.int64).reshape(-1, 2)
    out["course_owned"] = np.asarray(pipe.back.cloud_store.local_ids())
    out["course_map_shape"] = np.asarray(pipe.back.assemble_map(0.5).shape)


for phase in phases:
    {"core": core, "pipeline": pipeline, "mesh": mesh, "course": course}[phase]()
    print(f"proc {pid}: {phase} done", flush=True)
np.savez(os.path.join(out_dir, f"p{pid}.npz"), **out)
print("TORCH_MULTIHOST_OK", flush=True)
