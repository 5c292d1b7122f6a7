"""The signal half's analysis replayed as one CUDA graph a call.

``Engine.signal_analyze`` (the DSP chain, spectra, correlation pairs, peak
rings, means and plot ranges) is about a thousand small plain-PyTorch ops
on shapes the configuration fixes; none reads a value back to the host and
their constants are built once (``ops/dft``, ``ops/fir``).  Enqueued one by
one, the host's dispatch of each op costs several times its device time.
:class:`SignalGraphs` wraps the analysis as a function of its tensors and,
on a CUDA device, runs it eagerly the first time it sees a key (the inputs'
shapes and dtypes, the device, and the TF32 and float32 matmul-precision
settings: that call builds the constant caches and the cuBLAS handles),
captures it into a ``torch.cuda.CUDAGraph`` the second time, and replays
the graph on every later call with that key.  The kernels, their order and
their maths are the eager ones, so a replay is bit-equal to the eager call.

A replay reads static copies of the inputs (``copy_`` in) and the graph
writes every output into one flat arena (:func:`pack`), which is cloned
once after each replay; the call returns views of that clone
(:func:`unpack`).  Each call's outputs therefore own their storage: a
caller that keeps one call's state and outputs sees them unchanged after
the next replay.

The call stays eager on the CPU; when autograd would record (grad enabled
and an input requiring grad); while a torch function mode is active; for
inputs that are not contiguous; while the current stream is capturing (an
enclosing capture records the ops themselves); and while a profiler records
and the key has no graph yet.  A replay runs inside the span
``bpv.analyze``; the stage spans of the eager analysis (``bpv.dsp.*``,
``bpv.spectrum``, ``bpv.correlate``, ``bpv.outputs``) are host ranges and
appear on eager calls only.  Counters: ``signal_graph.captures`` and
``signal_graph.replays`` (``utils/profiling``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from bp_from_video_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor


def pack(outs: Sequence[Tensor]) -> tuple[Tensor, list]:
    """``outs`` (one dtype) flattened into one new tensor, in one launch;
    returns (arena, layout) for :func:`unpack`."""
    dtype = outs[0].dtype
    if any(o.dtype != dtype for o in outs):
        raise TypeError("pack: outputs of more than one dtype: "
                        f"{sorted({str(o.dtype) for o in outs})}")
    layout = [(o.shape, o.numel()) for o in outs]
    return torch.cat([o.reshape(-1) for o in outs]), layout


def unpack(arena: Tensor, layout: list) -> tuple[Tensor, ...]:
    """Views of ``arena`` in the shapes :func:`pack` recorded."""
    parts = arena.split([n for _, n in layout])
    return tuple(p.view(shape) for p, (shape, _) in zip(parts, layout))


def graph_key(args: Sequence[Tensor]):
    """What a captured graph is valid for, or None where the call must run
    eagerly (see the module docstring)."""
    dev = args[0].device
    if dev.type != "cuda":
        return None
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return None
    if torch._C._is_torch_function_mode_enabled():
        return None
    if not all(a.device == dev and a.is_contiguous() for a in args):
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    return (dev, tuple((a.shape, a.dtype) for a in args),
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


class CapturedCall:
    """``fn`` captured once on static copies of ``args``; calling it copies
    new inputs in, replays, and returns views of a clone of the arena."""

    def __init__(self, fn: Callable[..., Sequence[Tensor]],
                 args: Sequence[Tensor]):
        dev = args[0].device
        self.static = [torch.empty_like(a) for a in args]
        self._copy_in(args)
        self.graph = torch.cuda.CUDAGraph()
        # capture_begin/end on a side stream, as torch.cuda.graph does, but
        # without its synchronize and empty_cache: emptying the allocator's
        # cache would make the next calls allocate their blocks anew.
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.arena, self.layout = pack(fn(*self.static))
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _copy_in(self, args: Sequence[Tensor]) -> None:
        for s, a in zip(self.static, args):
            s.copy_(a)

    def __call__(self, args: Sequence[Tensor]) -> tuple[Tensor, ...]:
        self._copy_in(args)
        self.graph.replay()
        return unpack(self.arena.clone(), self.layout)


class SignalGraphs:
    """``fn(*tensors) -> tuple of tensors``, eager on a key's first call,
    captured on its second and replayed after (see the module docstring).
    """

    def __init__(self, fn: Callable[..., Sequence[Tensor]]):
        self.fn = fn
        self.seen: set = set()
        self.graphs: dict = {}

    def capture(self, args: Sequence[Tensor]) -> Callable:
        return CapturedCall(self.fn, args)

    def __call__(self, *args: Tensor) -> tuple[Tensor, ...]:
        key = graph_key(args)
        if key is None:
            return self.fn(*args)
        call = self.graphs.get(key)
        if call is None:
            if (key not in self.seen
                    or torch._C._autograd._profiler_enabled()):
                self.seen.add(key)
                return self.fn(*args)
            call = self.graphs[key] = self.capture(args)
            count("signal_graph.captures")
        count("signal_graph.replays")
        with span("bpv.analyze"):
            return call(args)
