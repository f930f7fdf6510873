"""PyTorch port: the native host-IO library and the KITTI reader (`native/`,
`io/kitti.py`), against the JAX package's binding on the same files, and the KITTI-layout
CLI run on the CPU.

The six cases of `tests/test_native.py` run against the port's `native`; where the JAX
package's binding reads the same file or cloud, the results are equal bit for bit (both
bind the same C++ source). The built library lands under the port's `build/` directory,
never next to the source. The CLI run writes a synthetic sequence in KITTI's on-disk
layout (`tests/test_kitti_e2e.py`) and reads it back through `--dataset kitti`: 8 frames
in the fast lane, the reference test's 20 as `slow`.
"""

import json
import os

import numpy as np
import pytest
import torch

from lidar_graph_slam_tpu import native as jnative
from lidar_graph_slam_tpu_torch import native
from lidar_graph_slam_tpu_torch.io import kitti
from lidar_graph_slam_tpu_torch.io.synthetic import SyntheticSequence
from tests.test_native import make_bins

PORT_DIR = os.path.dirname(os.path.abspath(native.__file__))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread for this module's tests, restored after it: an OpenMP
    pool per core in each of the suite's parallel test processes oversubscribes the cores
    so far that these tests slow down by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_kitti_layout(root, n_frames=20):
    """`tests/test_kitti_e2e.py:_write_kitti_layout`, at that test's motion per frame
    (0.2 laps over 20 frames) whatever the number of frames."""
    seq_dir = root / "sequences" / "00"
    velo = seq_dir / "velodyne"
    velo.mkdir(parents=True)
    (root / "poses").mkdir()
    seq = SyntheticSequence(n_frames=n_frames, seed=0, laps=0.01 * n_frames, max_points=8192)
    rows = []
    for i, (scan, gt) in enumerate(seq):
        rec = np.zeros((scan.shape[0], 4), np.float32)
        rec[:, :3] = scan
        rec.tofile(velo / f"{i:06d}.bin")
        rows.append(np.asarray(gt, np.float64)[:3].reshape(-1))
    np.savetxt(root / "poses" / "00.txt", np.stack(rows))
    # Identity velodyne->cam calib: poses are already in the sensor frame.
    (seq_dir / "calib.txt").write_text("Tr: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    return root


def test_native_builds_into_the_build_directory():
    assert native.available(), "g++ build of the port's lgs_io.cpp failed"
    path = native.build_info["path"]
    build_dir = os.path.join(os.path.dirname(PORT_DIR), "build")
    assert os.path.dirname(path) == build_dir and os.path.exists(path)
    assert not [f for f in os.listdir(PORT_DIR) if f.endswith(".so")]
    # Not the JAX package's library.
    assert os.path.realpath(path) != os.path.realpath(jnative._SO_PATH)


def test_read_bin_matches_numpy_and_reference(tmp_path, rng):
    paths = make_bins(tmp_path, rng, n_files=1)
    cap = 2048
    out, n = native.read_bin(paths[0], cap)
    raw = np.fromfile(paths[0], dtype=np.float32).reshape(-1, 4)
    assert n == min(raw.shape[0], cap)
    np.testing.assert_array_equal(out[:n], raw[:n, :3])
    assert (out[n:] == native.PAD_VALUE).all()
    j_out, j_n = jnative.read_bin(paths[0], cap)
    assert n == j_n
    np.testing.assert_array_equal(out, j_out)


def test_read_bin_truncates_to_capacity(tmp_path, rng):
    paths = make_bins(tmp_path, rng, n_files=1, n_pts=500)
    out, n = native.read_bin(paths[0], 100)
    assert n == 100 and out.shape == (100, 3)
    np.testing.assert_array_equal(out, jnative.read_bin(paths[0], 100)[0])


def test_prefetcher_yields_all_in_order(tmp_path, rng):
    paths = make_bins(tmp_path, rng, n_files=6)
    pf = native.ScanPrefetcher(paths, capacity=2048, depth=2)
    jpf = jnative.ScanPrefetcher(paths, capacity=2048, depth=2)
    seen = []
    for (pts, n), (j_pts, j_n) in zip(pf, jpf):
        raw = np.fromfile(paths[len(seen)], dtype=np.float32).reshape(-1, 4)
        np.testing.assert_array_equal(pts[: min(n, 2048)], raw[: min(n, 2048), :3])
        assert n == j_n
        np.testing.assert_array_equal(pts[:n], j_pts[:n])
        seen.append(n)
    assert len(seen) == 6
    pf.close()
    jpf.close()


def test_host_voxel_downsample_matches_reference(rng):
    pts = rng.uniform(-10, 10, size=(5000, 3)).astype(np.float32)
    got = native.voxel_downsample_host(pts, 1.0)
    # Oracle of `tests/test_native.py`: python dict grouping with the min-corner origin.
    coords = np.floor((pts - pts.min(0)) / 1.0).astype(np.int64)
    groups = {}
    for c, p in zip(map(tuple, coords), pts):
        groups.setdefault(c, []).append(p)
    oracle = np.stack([np.mean(np.stack(v), 0) for v in groups.values()])
    assert got.shape[0] == oracle.shape[0]
    a = np.array(sorted(map(tuple, np.round(got, 3))))
    b = np.array(sorted(map(tuple, np.round(oracle, 3))))
    np.testing.assert_allclose(a, b, atol=1e-2)
    np.testing.assert_array_equal(got, jnative.voxel_downsample_host(pts, 1.0))
    np.testing.assert_array_equal(native.voxel_downsample_host(pts, 1.0, out_capacity=100),
                                  got[:100])


def test_prefetcher_raises_on_unreadable_file(tmp_path, rng):
    paths = make_bins(tmp_path, rng, n_files=2)
    paths.insert(1, str(tmp_path / "missing.bin"))  # never created
    pf = native.ScanPrefetcher(paths, capacity=2048, depth=2)
    with pytest.raises(OSError):
        for _pts, n in pf:
            assert n >= 0
    pf.close()


def test_kitti_sequence_prefetcher_order(tmp_path):
    """The prefetcher path yields scans in file order with correct counts, and the
    ground truth equals the JAX package's reader's."""
    from lidar_graph_slam_tpu.io.kitti import KittiSequence as JKittiSequence

    _write_kitti_layout(tmp_path, n_frames=6)
    seq = kitti.KittiSequence(str(tmp_path), "00", max_points=8192)
    jseq = JKittiSequence(str(tmp_path), "00", max_points=8192)
    assert len(seq) == len(jseq) == 6 and seq.files == jseq.files
    np.testing.assert_array_equal(seq.gt_poses, jseq.gt_poses)
    direct = [kitti.read_velodyne_bin(f) for f in seq.files]
    for i, ((scan, gt), (j_scan, _)) in enumerate(zip(seq, jseq)):
        np.testing.assert_array_equal(scan, direct[i][: scan.shape[0]])
        assert scan.shape[0] == direct[i].shape[0]
        np.testing.assert_array_equal(scan, j_scan)
        assert gt is not None
    # Without read-ahead, and truncated through the native reader.
    plain = kitti.KittiSequence(str(tmp_path), "00", max_frames=2)
    assert [s.shape for s, _ in plain] == [d.shape for d in direct[:2]]
    assert kitti.read_velodyne_bin(seq.files[0], max_points=100).shape == (100, 3)


def test_kitti_readers_without_ground_truth(tmp_path):
    """No poses file: `gt_poses` is None and every scan comes with `None`; a calib
    without `Tr` reads as None."""
    root = _write_kitti_layout(tmp_path, n_frames=2)
    (root / "poses" / "00.txt").unlink()
    seq = kitti.KittiSequence(str(root), "00", max_points=8192)
    assert seq.gt_poses is None and [gt for _, gt in seq] == [None, None]
    (root / "sequences" / "00" / "calib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    assert kitti.read_calib_velo_to_cam(str(root / "sequences" / "00" / "calib.txt")) is None


SMALL_CAPACITY = [
    "capacity.raw_points=8192", "capacity.filtered_points=4096",
    "capacity.keyframe_points=4096", "capacity.max_keyframes=256",
    "capacity.voxel_capacity=32768", "capacity.loop_submap_points=65536",
    "capacity.max_loop_factors=16",
]


def _kitti_cli_run(tmp_path, n_frames, extra=()):
    from lidar_graph_slam_tpu_torch.pipeline import cli

    _write_kitti_layout(tmp_path, n_frames=n_frames)
    out = tmp_path / "out"
    rc = cli.main([
        "--dataset", "kitti", "--kitti-root", str(tmp_path), "--frames", str(n_frames),
        "--output", str(out), "--no-loop-closure", "--progress-every", "0",
        "--device", "cpu", *extra, *(a for v in SMALL_CAPACITY for a in ("--set", v))])
    assert rc == 0
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == n_frames and m["device"] == "cpu"
    assert m["keyframes"] >= 2
    # Ground truth flowed through poses/00.txt + calib Tr -> ATE is computed and sane.
    assert m["ate_odometry_m"] < 1.0, m
    for f in ("odometry_tum.txt", "odometry_kitti.txt", "keyframes_tum.txt", "map.pcd",
              "map.png"):
        assert (out / f).exists(), f
    assert np.loadtxt(out / "odometry_kitti.txt").shape == (n_frames, 12)
    return out, m


def test_kitti_cli_end_to_end(tmp_path):
    out, _ = _kitti_cli_run(tmp_path, 8, extra=("--live-render", "4"))
    assert (out / "live.png").exists()


@pytest.mark.slow
def test_kitti_cli_end_to_end_20_frames(tmp_path):
    """`tests/test_kitti_e2e.py:test_kitti_cli_end_to_end` on the port."""
    out, _ = _kitti_cli_run(tmp_path, 20)
    assert not (out / "live.png").exists()


def test_cli_without_ground_truth(tmp_path):
    """A sequence with no poses file: the run completes and the summary has no ATE."""
    from lidar_graph_slam_tpu_torch.pipeline import cli

    root = _write_kitti_layout(tmp_path, n_frames=4)
    (root / "poses" / "00.txt").unlink()
    out = tmp_path / "out"
    assert cli.main(["--dataset", "kitti", "--kitti-root", str(root), "--frames", "4",
                     "--output", str(out), "--no-loop-closure", "--progress-every", "0",
                     "--device", "cpu",
                     *(a for v in SMALL_CAPACITY for a in ("--set", v))]) == 0
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == 4 and "ate_odometry_m" not in m and "rpe_trans_m" not in m
    assert (out / "map.png").exists()
