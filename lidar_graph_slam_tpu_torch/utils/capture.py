"""One program, one dispatch: the port's counterpart of the JAX package's `jax.jit` with
donated arguments (`lidar_graph_slam_tpu/odometry/fused.py:141,221-223`).

A `Program` runs a body: a function of no arguments that reads its inputs from fixed
buffers and writes every result into fixed buffers in place (the counterpart of
donation: the next call finds its state where the last one left it).

  * On a CUDA device the first call runs the body on the owner's capture stream. This
    warm-up is that call's own run, and it makes what a capture may not: the kernel
    library (built at first use), the stream's kernel scratch
    (`ops/kernels.py:_stream_scratch`), its cuBLAS workspace and the cached constants.
    Then the body is captured into a `torch.cuda.CUDAGraph` with a private memory pool,
    and every later call replays the graph on the current stream: one `cudaGraphLaunch`
    where the body enqueues hundreds of operators. A capture or a replay that fails
    raises; nothing falls back to running the body eagerly. `release` frees the graph and
    its pool when the owner is done with them.
  * On the CPU every call runs the body on the same fixed buffers, so the CPU tests hold
    the body to the discipline the graph needs.
  * A body may return tensors it made (nested in tuples, lists or dataclasses): the
    program keeps them as `outputs`. On a card those of the capture live in the graph's
    pool and every replay rewrites them in place, so another program may read them where
    they lie; on the CPU each call's are copied into the first call's, which keeps their
    addresses as the graph does. A capture records without running: the first call's
    results are its warm-up's, and `warm_up` and `capture` may be called apart, so that
    a program reading another's outputs warms up on that one's warm-up results and is
    captured on its captured ones (`graph/slam.py:LoopPrograms`).

The wrappers' launch counts (`ops/kernels.py`) are host counters bumped when a wrapper is
called. The capture records its tally instead (`kernels.recorded_launches`), and each
replay counts it (`kernels.count_launches`), in the wrappers' counts and the calling
thread's. Captures use `capture_error_mode="thread_local"`: the loop verifier's thread
may launch and allocate on its own stream while the front end captures. The garbage
collector is run before a capture and held off during it (a graph freed mid-capture
invalidates the capture). A CUDA program's first call is timed in its parts
(`first_call_ms`): the warm-up's enqueue, the wait for its device work (the capture would
wait for it anyway: `torch.cuda.graph` synchronizes the card on entry), the collection,
and the capture with its instantiation.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from lidar_graph_slam_tpu_torch.ops import kernels


class Program:
    """`body` as one dispatch on `device`; `stream` (a `torch.cuda.Stream` of the card) is
    where a CUDA program warms up and is captured."""

    def __init__(self, body: Callable[[], object], device, stream=None):
        self.body = body
        self.device = torch.device(device)
        if self.device.type == "cuda" and stream is None:
            raise ValueError("Program: a CUDA program needs its capture stream")
        self.stream = stream
        self.graph = None
        self.tally: dict = {}  # wrapper -> kernel launches a replay
        self.captures = 0
        self.replays = 0
        self.outputs = None  # what the body returned, at fixed addresses
        self.first_call_ms: dict = {}  # warm_up, drain, collect, capture (the last capture)
        self._clock: list = []

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self._keep(self.body())
        elif self.graph is None:
            self.warm_up()
            self.capture()
        else:
            self.graph.replay()
            kernels.count_launches(self.tally)
            self.replays += 1

    def _keep(self, out) -> None:
        if out is None:
            return
        if self.outputs is None or self.device.type == "cuda":
            self.outputs = out
        else:
            copy_into(self.outputs, out)

    def warm_up(self) -> None:
        """The first call's own run: on a card, the body on the capture stream (the
        current stream waits for it); on the CPU, a call."""
        if self.device.type != "cuda":
            self._keep(self.body())
            return
        self._clock = [time.perf_counter()]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._keep(self.body())
        current.wait_stream(self.stream)
        self._clock.append(time.perf_counter())

    def capture(self) -> None:
        """Capture the body into the graph after `warm_up` (nothing on the CPU)."""
        if self.device.type != "cuda":
            return
        clock = self._clock
        torch.cuda.synchronize(self.device)
        clock.append(time.perf_counter())
        graph = torch.cuda.CUDAGraph()
        # Garbage must not be freed while the stream captures: another program's graph
        # among it would release its pool, a CUDA call a capture does not permit, which
        # invalidates the capture. Collect it first, and hold the collector off until the
        # capture ends.
        gc.collect()
        clock.append(time.perf_counter())
        enabled = gc.isenabled()
        gc.disable()
        try:
            with kernels.recorded_launches() as tally, torch.cuda.graph(
                    graph, stream=self.stream, capture_error_mode="thread_local"):
                out = self.body()
        finally:
            if enabled:
                gc.enable()
        clock.append(time.perf_counter())
        self._keep(out)
        self.graph, self.tally = graph, tally
        self.captures += 1
        self.first_call_ms = {part: 1000 * (b - a) for part, a, b in zip(
            ("warm_up", "drain", "collect", "capture"), clock, clock[1:])}

    def release(self) -> None:
        """Free the graph and its private pool now; a later call captures anew."""
        if self.graph is not None:
            self.graph.reset()
            self.graph, self.tally = None, {}

    def pool_bytes(self) -> int | None:
        """The bytes of the graph's private memory pool (None before the capture)."""
        if self.graph is None:
            return None
        pool = tuple(self.graph.pool())
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


def copy_into(dst, src) -> None:
    """Copy every tensor of `src` into the same place of `dst` (tensors, tuples or lists
    of them, or dataclasses of them, nested; None where both hold none), in place."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)
    else:
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
