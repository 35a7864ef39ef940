"""The one-call detector and its grid as captured CUDA graphs, replayed on
the card.

Port of JAX's compiled detect programs: ``hypad_tpu.detect.scorer`` jits
the one-call detector's body ``_detect_core`` into one device program a
static configuration (``_detect_device``, hypad_tpu/detect/scorer.py:621,
and ``_detect_device_scores_only``, :634) and the grid of every (rec_error
x combination) cell likewise (``_grid_device``, :1319). Here
``scorer.detect_scores`` and ``scorer.detect_scores_grid`` run the same
bodies (``scorer._detect_core``, ``scorer._grid_core``) through a
:class:`DetectProgram`, one for each configuration:

* the first call of a configuration runs the body eagerly, on the current
  stream and on the caller's windows put on the device, as a call without
  a program does (the warm-up: K1's plans and the KDE kernels' attributes
  are made here), and its outputs are that call's;
* the second allocates the program's static (N, W) float32 input buffer,
  captures the body into a ``torch.cuda.CUDAGraph`` (the capture runs
  nothing) and replays it;
* every later call replays.

So a one-off call runs as it would without programs: it pays no capture
and holds no buffer, graph or pool, only the program's count of calls.
From the second call on, each call copies its windows into the static
buffer (from the host, or device to device), which is the only input the
body reads besides the parameters; the outputs are the tensors the
captured body produced, in the graph's private pool, rewritten by each
replay, so a caller copies what it keeps before the program's next call.
The wrappers' launch counters advance after each replay by what the graph
captured (``utils/capture.py``): the counts of a call are the eager call's.
A capture or a replay that fails raises; nothing goes back to the eager
path.

A program is keyed by its configuration (entry, geometry, combinations,
rec_errors, KDE version), N and W, the device and every parameter's
address: a model whose tensors were replaced gets a new capture, never a
graph that reads freed memory, while a parameter updated in place
(training, ``load_state_dict``) is read as it is. Each model's programs are
kept in a ``weakref.WeakKeyDictionary`` on the parameters' module, at most
``MAX_PROGRAMS`` of them: the least recently used one is evicted, its graph
and its private pool freed.

Only a device that takes graphs (CUDA) gets programs; elsewhere, and
inside :func:`eager`, :func:`program_for` gives None and the scorer runs its
body eagerly.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import OrderedDict

import torch

from hypad_tpu_torch.utils.capture import advance_counters, counted_capture

# programs kept for each model; the least recently used is evicted. A
# captured program holds its static input and its pool, the body's live
# intermediates at their peak: 6-7 KB a window on an H100 (117 MB at
# 20,000 windows, 1.86 GB at ``ONE_CALL_MAX_WINDOWS``; chip_smoke.py's
# [detect_graph]), so one model's programs hold at most about 15 GB
MAX_PROGRAMS = 8

_PROGRAMS = weakref.WeakKeyDictionary()   # params module -> OrderedDict
_withheld = 0                             # depth of open eager() contexts


class _CudaGraph:
    """One body captured on the card: :meth:`capture` records ``body()``
    (which runs nothing) and returns its outputs, in the graph's private
    pool; :meth:`replay` enqueues the graph on the current stream, which
    rewrites them."""

    def __init__(self, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body):
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            return body()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()

    def reset(self):
        self.graph.reset()


def _graph_factory(device):
    """The graph type a program on ``device`` captures into, or None where
    the device takes no graph (the CPU, whose calls stay eager)."""
    return _CudaGraph if device.type == "cuda" else None


class DetectProgram:
    """One configuration's body on one (N, W) shape: its count of calls,
    and from its second call on its static input buffer, its graph, the
    outputs the graph rewrites and the launches it holds."""

    def __init__(self, shape, device, graph_type):
        self.shape = tuple(shape)
        self.device = device
        self.graph_type = graph_type
        self.calls = 0
        self.X = None
        self.graph = None
        self.outputs = None
        self.launches = {}      # (wrapper, counter) -> n a replay

    def run(self, params, X, body):
        """``body(params, Xt)`` of the windows ``X`` (numpy or a tensor,
        (N, W)). The first call runs it eagerly on ``X`` put on the device;
        later ones copy ``X`` into the static buffer ``self.X`` and replay
        the graph the second call captured. Returns (the body's tuple of
        device tensors, the device windows ``Xt`` it read); a replay's are
        the program's own, valid until its next call."""
        with torch.inference_mode():
            if self.calls == 0:
                Xt = X if torch.is_tensor(X) else torch.as_tensor(X)
                Xt = Xt.to(device=self.device, dtype=torch.float32)
                Xt = Xt.contiguous()
                out = body(params, Xt)
            else:
                if self.X is None:
                    self.X = torch.empty(self.shape, dtype=torch.float32,
                                         device=self.device)
                self.X.copy_(X if torch.is_tensor(X) else torch.as_tensor(X))
                if self.graph is None:
                    self._capture(params, body)
                self.graph.replay()
                advance_counters(self.launches, 1)
                out, Xt = self.outputs, self.X
        self.calls += 1
        return out, Xt

    def _capture(self, params, body):
        graph = self.graph_type(self.device)
        self.outputs, self.launches = counted_capture(
            lambda: graph.capture(lambda: body(params, self.X)))
        self.graph = graph

    def release(self):
        """Drop the graph, its outputs and the static buffer, so that its
        pool is freed."""
        self.outputs = self.X = None
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


@contextlib.contextmanager
def eager():
    """Within it ``detect_scores`` and ``detect_scores_grid`` neither make
    nor use a program: every call runs its body eagerly (the eager side of
    a measurement or a check). The programs kept stay as they were."""
    global _withheld
    _withheld += 1
    try:
        yield
    finally:
        _withheld -= 1


def program_for(params, config, shape, device):
    """The :class:`DetectProgram` of ``params`` (the model's module) for
    ``config`` (a hashable of what fixes the body besides the shape) on
    (N, W) ``shape`` on ``device``: the one kept for the same key, or a new
    one, kept (evicting the least recently used past ``MAX_PROGRAMS``).
    None where ``device`` takes no graph, and inside :func:`eager`."""
    graph_type = None if _withheld else _graph_factory(device)
    if graph_type is None:
        return None
    key = (config, tuple(shape), str(device),
           tuple(p.data_ptr() for p in params.parameters()))
    programs = _PROGRAMS.setdefault(params, OrderedDict())
    prog = programs.get(key)
    if prog is not None:
        programs.move_to_end(key)
        return prog
    prog = programs[key] = DetectProgram(shape, device, graph_type)
    while len(programs) > MAX_PROGRAMS:
        programs.popitem(last=False)[1].release()
    return prog


def programs(params):
    """The programs kept for ``params``, least recently used first."""
    return list(_PROGRAMS.get(params, {}).values())


def release_programs(params):
    """Free every program of ``params`` (its graphs and their pools)."""
    for prog in _PROGRAMS.pop(params, {}).values():
        prog.release()
