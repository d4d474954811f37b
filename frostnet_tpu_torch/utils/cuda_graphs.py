"""A step of many small launches, replayed as a CUDA graph.

A served detection request issues some 900 launches for about 6 ms of the
card's work; issued one by one from Python they take the host 15-20 ms, so
the host's speed, not the card's, sets the request's pace. :class:`Replay`
captures such a step once per input shape and replays it: the same kernels
on the same operands, so the same bits, for one launch of the host.

Off the card, with autograd recording, or inside another capture, a
:class:`Replay` calls its function as it is.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


class Replay:
    """``fn(*tensors)`` on a CUDA device, replayed from a CUDA graph.

    The first call at a key (the arguments' shapes, dtypes and device, and
    whether inference mode is on) runs ``fn`` as it is: the libraries' and
    the kernels' first-call work, and a caller that watches one call's
    modules or launches, see plain eager work. The second runs ``fn`` once
    more on a side stream and captures it on that stream over static copies
    of the arguments. From then on a call copies its arguments into the
    static ones, replays the graph, and returns copies of its outputs (a
    tensor or a tuple of tensors), which the next replay does not
    overwrite. ``fn`` must launch the same work whatever the arguments'
    values hold: no host reads of the device, no value-dependent shapes.
    Each key keeps its graph and its memory pool for the object's life."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: Dict[Tuple, tuple] = {}

    def __call__(self, *args):
        dev = args[0].device
        if (dev.type != "cuda" or torch.is_grad_enabled()
                or torch.cuda.is_current_stream_capturing()):
            return self.fn(*args)
        key = (tuple((tuple(a.shape), a.dtype, a.device) for a in args),
               torch.is_inference_mode_enabled())
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = ()
            return self.fn(*args)
        if not entry:
            entry = self._graphs[key] = self._capture(args, dev)
        static, graph, outs = entry
        for s, a in zip(static, args):
            s.copy_(a)
        graph.replay()
        return _clone(outs)

    def _capture(self, args, dev):
        with torch.cuda.device(dev):
            static = [a.clone() for a in args]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*static)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                outs = self.fn(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
        return static, graph, outs
