"""Structured telemetry: the per-frame metrics stream.

Port of `MetricsWriter` (`lidar_graph_slam_tpu/utils/telemetry.py:18-45`). The
reference's `trace` span wraps `jax.profiler`; its `torch.profiler` counterpart is not
ported yet.
"""

from __future__ import annotations

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
