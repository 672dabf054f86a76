"""Decode steps replayed as CUDA graphs: in torch, the job of the
reference's ``jax.jit`` of a ``lax.scan`` decode loop.

A ``StepGraph`` wraps a step function that reads static buffers (the token,
the position, the step index, the keys; the caches it owns) and writes them
in place, so that calling it again runs the next step.  On a CUDA device
the first call runs the step once on a side stream, which is the step's
warm-up: it builds and loads the kernels' libraries and fills their cached
launch plans.  It then captures one step with ``torch.cuda.graph`` (a
capture runs nothing), and every later call replays that graph on the
current stream.  On the CPU every call runs the step eagerly.

A capture or a replay that fails raises: on a CUDA device the step never
falls back to eager.  A step therefore makes no host sync (``.item()``,
``int`` or ``bool`` of a device value, a boolean index) and no
host-to-device copy (a Python number or list made into a device tensor:
the port fills such constants in on the device), and every tensor it keeps
lives in its buffers.
"""
from __future__ import annotations

import time

import torch


class StepGraph:
    """One step function, captured once on a CUDA device and replayed.

    ``capture_s`` is the host time of the warm-up step and the capture
    (None until the first call on a CUDA device); ``replays`` counts the
    calls served by the graph; ``captured_calls`` is how many calls of the
    port's kernel wrappers the capture recorded.  A wrapper counts its own
    calls, so a capture counts them once though it launches nothing, and a
    replay launches them all again without counting.
    """

    def __init__(self, step, device):
        self.step = step
        self.device = torch.device(device)
        self.graph = None
        self.capture_s = None
        self.replays = 0
        self.captured_calls = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.step()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1

    def _warm_up_and_capture(self) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.step()             # this call's step
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            calls = _wrapper_calls()
            with torch.cuda.graph(graph):
                self.step()             # recorded, not run
        self.captured_calls = _wrapper_calls() - calls
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


def _wrapper_calls() -> int:
    """Calls of the port's kernel wrappers so far (each wrapper's
    ``launches``)."""
    from repro_torch.kernels.fault_inject.kernel import fault_inject
    from repro_torch.kernels.fused_decode.kernel import fused_decode
    from repro_torch.kernels.protected_mm.kernel import protected_mm
    from repro_torch.kernels.qmatmul.kernel import qmatmul
    return sum(f.launches for f in (fault_inject, fused_decode,
                                    protected_mm, qmatmul))
