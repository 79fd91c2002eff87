"""Training steps replayed as captured CUDA graphs: the port's counterpart
of the JAX package's jitted `lax.scan` over steps.

A step body here is a function of no arguments whose every effect lies in
tensors it updates in place: the parameters, the optimizer's moments,
count and learning rate (train/optimizers.py), the BatchNorm statistics,
the generators it draws from, a device-side step counter and the output
buffers it writes at that counter. Its host-side effects are the kernel
wrappers' launch counts, nothing else.

`StepGraph(body, generators, device, capture)` runs such a body once a
call:
  - On the CPU, or with capture=False (a body whose collectives run on
    gloo, which a graph cannot hold), it calls the body: the plain loop.
  - On a CUDA device its first call is the warm-up, a real run of the body
    on a side stream, which builds the kernels (ops/kernels.py builds at
    first use) and creates cuBLAS's and cuDNN's handles and workspaces for
    that stream; it then captures the body on the same stream into a
    `torch.cuda.CUDAGraph`, which records the kernels without running them.
    Every later call replays the graph. So the warm-up is one of the real
    runs: no step is lost and none runs twice.
  - The generators are registered with the graph before the capture, so
    each replay draws at the generator's current offset and advances it by
    what the capture drew: dropout masks and augment draws are fresh on
    every replay, and an eager draw after the replays sees the generator
    where as many eager steps would have left it. An unregistered
    generator would hand every replay the draws of the capture.
  - `kernels.launch_counts` stays exact: a capture bumps the counters on
    the host without launching anything, and a replay launches without
    bumping them. The change across the capture is taken back and added
    again on each replay.
  - A capture that fails raises: on a CUDA tensor there is no eager
    fallback.
  - Under a profiler each replay is the span `seld.train.replay` and the
    warm-up and capture `seld.train.capture` (utils/profiling.py); the
    body itself carries no span, which would run at the capture alone.

`StepLoop(one_step, generators, device, unroll, capture)` runs a one-step
body `steps` times a call: `unroll` steps to a graph, and the rest of a
call (steps % unroll) through a second graph of that many steps, so the
result does not depend on `unroll`.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Sequence

import torch

from seld_tpu_torch.ops import kernels
from seld_tpu_torch.utils.profiling import span


class StepGraph:
    def __init__(self, body: Callable[[], None],
                 generators: Sequence[torch.Generator], device,
                 capture: bool = True):
        self.body = body
        self.generators = tuple(generators)
        self.device = torch.device(device)
        self.capture = capture
        self.graph = None
        self.launches: collections.Counter = collections.Counter()

    def __call__(self) -> None:
        if self.device.type != "cuda" or not self.capture:
            self.body()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            with span("seld.train.replay"):
                self.graph.replay()
                kernels.launch_counts.update(self.launches)

    def _warm_up_and_capture(self) -> None:
        with span("seld.train.capture"):
            current = torch.cuda.current_stream(self.device)
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.body()
            current.wait_stream(stream)

            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            before = collections.Counter(kernels.launch_counts)
            try:
                with torch.cuda.graph(graph, stream=stream):
                    self.body()
            finally:
                captured = kernels.launch_counts - before
                kernels.launch_counts.subtract(captured)
            self.launches = captured
            self.graph = graph


class StepLoop:
    def __init__(self, one_step: Callable[[], None],
                 generators: Sequence[torch.Generator], device,
                 unroll: int = 1, capture: bool = True):
        self.one_step = one_step
        self.generators = tuple(generators)
        self.device = torch.device(device)
        self.unroll = int(unroll)
        self.capture = capture
        self._graphs: Dict[int, StepGraph] = {}

    def run(self, steps: int) -> None:
        full, rest = divmod(int(steps), self.unroll)
        for _ in range(full):
            self._graph(self.unroll)()
        if rest:
            self._graph(rest)()

    def _graph(self, n: int) -> StepGraph:
        graph = self._graphs.get(n)
        if graph is None:
            # the body holds the step, not the loop: no reference cycle,
            # so dropping the loop frees what the step holds at once
            one_step = self.one_step

            def body():
                for _ in range(n):
                    one_step()
            graph = self._graphs[n] = StepGraph(body, self.generators,
                                                self.device, self.capture)
        return graph
