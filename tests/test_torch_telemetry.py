"""PyTorch port: `utils/telemetry.py` — `StageTimers` against the JAX package's on the
same samples (equal: both are host code), and the `trace` span on the CPU with and
without a profile directory."""

import json
import os
import time

import numpy as np
import torch

from lidar_graph_slam_tpu.utils import telemetry as jtel
from lidar_graph_slam_tpu_torch.utils import telemetry as ttel


def test_stage_timers_summary_matches_reference():
    a, b = ttel.StageTimers(), jtel.StageTimers()
    for stage, n in (("register", 5), ("backend", 2)):
        for _ in range(n):
            with a.time(stage):
                time.sleep(0.002)
    b.samples = {k: list(v) for k, v in a.samples.items()}
    sa, sb = a.summary(), b.summary()
    assert sa == sb and set(sa) == {"register", "backend"}
    assert sa["register"]["count"] == 5 and sa["backend"]["count"] == 2
    rec = sa["register"]
    assert 2.0 <= rec["p50_ms"] <= rec["p99_ms"] <= rec["max_ms"] < 500.0
    assert set(rec) == {"mean_ms", "p50_ms", "p99_ms", "max_ms", "count"}
    assert ttel.StageTimers().summary() == {}


def test_trace_times_the_span():
    with ttel.trace("span"):
        time.sleep(0.01)
    assert 10.0 <= ttel.trace.last_ms < 1000.0


def test_trace_writes_a_profile(tmp_path):
    x = torch.randn(256, 256)
    prof_dir = tmp_path / "profile"
    with ttel.trace("frame", profile_dir=str(prof_dir)):
        (x @ x).sum().item()
    assert ttel.trace.last_ms > 0.0
    path = prof_dir / "frame.trace.json"
    assert path.exists() and os.path.getsize(path) > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "frame" for e in events)


def test_metrics_writer_matches_reference(tmp_path):
    pa, pb = tmp_path / "a" / "m.jsonl", tmp_path / "b" / "m.jsonl"
    for mod, p in ((ttel, pa), (jtel, pb)):
        w = mod.MetricsWriter(str(p))
        w.emit({"frame": 0, "fitness": np.float32(0.5).item()})
        w.close()
    ra, rb = (json.loads(p.read_text()) for p in (pa, pb))
    ra.pop("ts"), rb.pop("ts")
    assert ra == rb == {"frame": 0, "fitness": 0.5}
