"""Structured telemetry: the per-frame metrics stream, the profiler span and the
per-stage timers.

Port of `lidar_graph_slam_tpu/utils/telemetry.py`: `MetricsWriter`, `trace` (the
reference wraps `jax.profiler`; here `torch.profiler`) and `StageTimers`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class MetricsWriter:
    """Append-only JSONL metrics stream (one record per frame/event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        record = {"ts": time.time(), **record}
        self.records.append(record)
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def trace(label: str, profile_dir: Optional[str] = None):
    """Wall-clock span timer; the span is named `label` for any profiler that is
    recording (`torch.profiler.record_function`). When `profile_dir` is set, a
    `torch.profiler` session also records the span's CPU and CUDA activity and writes a
    Chrome trace, `<profile_dir>/<label>.trace.json`.

    `trace.last_ms` holds the last span's wall time in ms. With a CUDA card the device is
    synchronized before the clock is read at the end of the span (and before it starts),
    so the time covers the device work the span enqueued.

    A `torch.profiler` session can leave its process slower afterwards: on an NVIDIA H100
    the dense-course frames of a process that had profiled read 132-136 ms p50 against
    89 ms for one that had not (cause not isolated). Profile in a process whose later
    frame times nobody reads, e.g. a subprocess."""
    import torch

    on_card = torch.cuda.is_available()
    prof = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        with torch.profiler.record_function(label):
            yield
        if on_card:
            torch.cuda.synchronize()
    trace.last_ms = 1000 * (time.perf_counter() - t0)
    if prof is not None:
        prof.export_chrome_trace(os.path.join(profile_dir, f"{label}.trace.json"))


class StageTimers:
    """Rolling per-stage timing aggregation (mean/p50/p99/max), on the host's clock."""

    def __init__(self):
        self.samples: dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        yield
        self.samples.setdefault(stage, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        import numpy as np

        out = {}
        for stage, ts in self.samples.items():
            a = np.asarray(ts)
            out[stage] = {
                "mean_ms": float(a.mean() * 1000),
                "p50_ms": float(np.percentile(a, 50) * 1000),
                "p99_ms": float(np.percentile(a, 99) * 1000),
                "max_ms": float(a.max() * 1000),
                "count": int(a.size),
            }
        return out
