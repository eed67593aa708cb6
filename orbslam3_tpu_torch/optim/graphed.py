"""CUDA-graph replay of the per-frame solvers.

A tracked frame's pose solve is 4 rounds of 10 (pose-only) or 5
(pose-inertial) damped Gauss-Newton iterations of small tensor ops:
thousands of kernel launches a call, each issued from Python, so the card
waits on the host (PERF.md section 5). The solves read nothing back to the
host and their shapes are fixed per System (the feature budget), so each
signature is captured once into a `torch.cuda.CUDAGraph` and then
replayed: the same kernels on the same inputs, issued by one call. Tensors
on the CPU go through the function as written.

A captured function takes only tensors besides its static arguments, makes
no host read and no host-to-device copy, and returns a tensor or a
(Named)tuple of them; every tensor it reads is one of its arguments.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from orbslam3_tpu_torch import spans

# (fn, static, signature of the tensors) -> _Captured, for the process's
# life: one graph per solver and System configuration.
_GRAPHS: Dict[tuple, "_Captured"] = {}
CAPTURES = 0  # graphs captured in this process; each also `spans.count("graph_capture")`
REPLAYS = 0  # replays of a captured graph


def _map(f, tree):
    if isinstance(tree, torch.Tensor):
        return f(tree)
    vals = [_map(f, x) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


class _Captured:
    """One signature's graph: static copies of the inputs, the graph, and
    the outputs it writes on every replay."""

    def __init__(self, fn: Callable, static: tuple, tensors: Tuple[torch.Tensor, ...]):
        self.inputs = tuple(t.clone() for t in tensors)
        side = torch.cuda.Stream(device=tensors[0].device)
        side.wait_stream(torch.cuda.current_stream(tensors[0].device))
        with torch.cuda.stream(side):
            # One eager run first: the solver libraries' handles and
            # workspaces are made outside the capture.
            fn(*static, *self.inputs)
            # capture_begin / capture_end, not `torch.cuda.graph`, whose
            # entry synchronizes the device and empties the allocator's cache.
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = fn(*static, *self.inputs)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(tensors[0].device).wait_stream(side)

    def __call__(self, tensors):
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)
        self.graph.replay()
        return _map(torch.clone, self.outputs)


def run(fn: Callable, static: tuple, tensors: Tuple[torch.Tensor, ...]):
    """`fn(*static, *tensors)`, replayed from a CUDA graph when the tensors
    lie on a CUDA device (captured at the first call of each signature:
    `fn`, `static` and the tensors' shapes, dtypes and devices). The
    outputs are fresh tensors."""
    global CAPTURES, REPLAYS
    if not tensors[0].is_cuda:
        return fn(*static, *tensors)
    key = (fn, static, tuple((t.shape, t.dtype, t.device) for t in tensors))
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = _Captured(fn, static, tensors)
        CAPTURES += 1
        spans.count("graph_capture")
    REPLAYS += 1
    return g(tensors)
