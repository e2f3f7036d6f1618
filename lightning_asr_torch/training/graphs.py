"""The train step as one CUDA graph per input key (``make_train_step``'s
route on the card).

On the H100 a train step of the default recipe is about 2,800 kernel
launches at 24-43 host microseconds each, for about 41 ms of device work:
the host sets the pace.  ``GraphedStep`` records a step's whole chain of
kernels, hand-written ones and library ones alike, into one
``torch.cuda.CUDAGraph`` and replays it, one launch for all of them.

Each call takes one route, from what the call can observe (``route``):

  * ``eager/<reason>``, the step as written: ``cpu`` (a batch tensor off
    the card), ``batch`` (a batch entry that is no tensor), ``state`` (a
    state shaped otherwise than the one the graphs hold), the step's own
    reason (``make_train_step`` gives ``data_parallel`` and
    ``accum_steps``), ``limit`` (``MAX_GRAPHS`` graphs held) and
    ``failed`` (the key's capture failed);
  * ``capture``: a key's first call records the step into a graph.  While
    no graph is held, the call first runs the step eagerly, as written, and
    returns that result: the run warms cuDNN, cuBLAS and the kernel
    libraries.  Once one is held the call records the key's graph straight
    away and replays it for its result;
  * ``replay``: every later call of the key.

So a caller's warm-up steps, one a shape, hold the captures, and its later
steps only replay.  A caller whose shapes never repeat pays a capture a
shape until ``MAX_GRAPHS`` are held, then nothing.  Each graph is put on
the card when it is recorded (``_upload``), so its first replay costs no
more than the others.

A key is the batch's names, shapes, dtypes and devices and the identity of
the generator object; each graph holds its generator, so that the identity
stays its own.

The graph reads and writes buffers that the ``GraphedStep`` owns: one set
of state buffers for every graph, which a graph also writes the new state
into as its last work, and each key's batch buffers.  A replay copies the
caller's state and batch into them (``torch._foreach_copy_``, one a
dtype: a few launches), replays, and copies the state and the metrics out
into fresh tensors: a state or metrics returned earlier stays as it was,
as the eager step's do.  States and outputs are flattened by
``torch.utils._pytree`` (``AsrTrainState`` is registered in
``training/steps.py``).  All graphs allocate from one memory pool; besides
the pool a graph holds its batch buffers and its metrics.

Random draws: the caller's generator is registered with the graph
(``CUDAGraph.register_generator_state``).  A capture leaves the
generator's seed and offset as they are; a replay reads them at that moment
and moves the offset on by the graph's draws, as the eager step does, so a
replay gives the eager step's bits on the same state, batch and generator
state (with cuDNN's deterministic algorithms, fixed when the graph is
recorded: without them two eager calls differ too, in the 1x1
convolutions' weight gradients; the Conformer's step needs PyTorch's
deterministic algorithms, ``torch.use_deterministic_algorithms(True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, for the same reason: its
memory-efficient attention's backward sums in any order otherwise).

A capture that fails (an op that syncs the host or uploads from it, or
cannot be captured) leaves its key eager, counted under ``eager/failed``;
the call runs the step eagerly (or has done so already), and never
raises.  The generator
states it registered stay in capture mode, so the generators get fresh
copies of theirs and the graphs held go, to be captured again
(``_retire``).

The kernel wrappers count their launches (``fn.launches``, and by hidden
size ``fn.launches_at``) when Python calls them.  A capture calls them
without running a kernel and a replay runs the kernels without calling
them, so the capture takes back what it counted and each replay adds it.

``counts`` holds every call's route.  Inside ``training/profiler.py``'s
``tracing`` the recording and the replay are the spans ``capture`` and
``replay``, under the caller's open span; an eager run, a capturing call's
too, opens the step's own spans there.
"""

from __future__ import annotations

import collections
import ctypes
import logging
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree

from ..ops.ctc_kernels import ctc_alpha, ctc_beta
from ..ops.depthwise_kernels import depthwise_wgrad
from ..ops.frontend_kernels import extend_preemph, mel_from_extended
from ..ops.lstm_kernels import lstm_backward, lstm_backward_stacked, lstm_recurrence, \
    lstm_recurrence_stacked
from ..ops.sepconv_kernels import sepconv_backward, sepconv_forward
from .profiler import span

logger = logging.getLogger(__name__)

# The trainer's bucket batcher makes a key a bucket and target width: 11
# duration buckets by a few widths (multiples of 32) each.
MAX_GRAPHS = 64

# the kernel wrappers that count their launches
COUNTED = (mel_from_extended, extend_preemph, ctc_alpha, ctc_beta, lstm_recurrence, lstm_backward,
           lstm_recurrence_stacked, lstm_backward_stacked, sepconv_forward, sepconv_backward,
           depthwise_wgrad)


def launch_counts() -> dict:
    """{wrapper: (launches, {hidden size: launches})} of ``COUNTED``."""
    return {fn: (fn.launches, dict(getattr(fn, "launches_at", {}))) for fn in COUNTED}


def launches_since(before: dict) -> dict:
    """What ``COUNTED`` counted since ``launch_counts()`` gave ``before``."""
    out = {}
    for fn, (n, at) in launch_counts().items():
        n0, at0 = before[fn]
        out[fn] = (n - n0, {h: k - at0.get(h, 0) for h, k in at.items() if k != at0.get(h, 0)})
    return out


def add_launches(counted: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counted`` (``launches_since``'s) to the wrappers'
    counts."""
    for fn, (n, at) in counted.items():
        fn.launches += sign * n
        for h, k in at.items():
            fn.launches_at[h] = fn.launches_at.get(h, 0) + sign * k


_CUDA = None    # libcuda, loaded at the first capture


def _upload(graph, stream) -> None:
    """Put the instantiated ``graph`` on the card now (``cuGraphUpload``,
    ordered on ``stream``), not at its first replay: there the launch holds
    the host until the stream's queued steps have run (tens of ms)."""
    global _CUDA
    _CUDA = _CUDA or ctypes.CDLL("libcuda.so.1")
    err = _CUDA.cuGraphUpload(ctypes.c_void_p(graph.raw_cuda_graph_exec()),
                              ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"cuGraphUpload failed: CUDA error {err}")


def _tensors(flat: list) -> list:
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _copy(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` for every i: one ``torch._foreach_copy_`` a
    dtype, whose fused route takes lists of one dtype, so a few launches."""
    groups: dict = collections.defaultdict(lambda: ([], []))
    for d, s in zip(dst, src):
        group = groups[d.dtype]
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class _Graph(NamedTuple):
    graph: Any                            # torch.cuda.CUDAGraph
    batch: dict                           # the key's batch buffers
    out: list                             # (state, metrics)'s leaves as recorded
    out_spec: Any                         # and their tree
    generator: Optional[torch.Generator]  # held: its identity is in the key
    launches: dict                        # the wrappers' launches a replay runs


class GraphedStep:
    """``fn(state, batch, generator) -> (new_state, metrics)``, a step whose
    new state is shaped as its state, called through one CUDA graph per key
    (the module docstring); ``reason``, where given, keeps every call
    eager."""

    def __init__(self, fn: Callable, reason: Optional[str] = None):
        self.fn = fn
        self.reason = reason
        self.counts = collections.Counter()
        self._failed: set = set()
        self._graphs: dict = {}
        self._state_spec = None               # the state buffers' tree
        self._state_bufs: list = []           # and their leaves
        self._pool = None
        self._stream = None

    def key(self, spec, batch: dict, generator: Optional[torch.Generator]):
        """(key, reason): the call's key, and a reason that keeps it eager
        whatever its key, or None; ``spec`` is the state's tree."""
        if not all(isinstance(v, torch.Tensor) for v in batch.values()):
            return None, "batch"
        key = (tuple((k, v.shape, v.dtype, v.device) for k, v in batch.items()), id(generator))
        if self._state_spec is not None and spec != self._state_spec:
            return key, "state"
        return key, None if all(v.is_cuda for v in batch.values()) else "cpu"

    def route(self, key, reason: Optional[str] = None) -> str:
        """``replay``, ``capture`` or ``eager/<reason>`` for a call of
        ``key``."""
        reason = reason or self.reason
        if reason:
            return f"eager/{reason}"
        if key in self._graphs:
            return "replay"
        if key in self._failed:
            return "eager/failed"
        if len(self._graphs) >= MAX_GRAPHS:
            return "eager/limit"
        return "capture"

    def __call__(self, state, batch: dict, generator: Optional[torch.Generator] = None):
        flat, spec = pytree.tree_flatten(state)
        key, reason = self.key(spec, batch, generator)
        how = self.route(key, reason)
        if how == "replay":
            self.counts[how] += 1
            with span(how):
                return self._replay(self._graphs[key], flat, batch)
        if how != "capture":
            self.counts[how] += 1
            return self.fn(state, batch, generator)
        warm = bool(self._graphs)
        out = None if warm else self.fn(state, batch, generator)
        with span(how):
            try:
                graph = self._capture(flat, spec, batch, generator)
            except RuntimeError:
                logger.warning("train step: the capture of %s failed; the key stays eager", key,
                               exc_info=True)
                self._failed.add(key)
                self._retire(generator, next(iter(batch.values())).device)
                how = "eager/failed"
            else:
                self._graphs[key] = graph
                if warm:
                    out = self._replay(graph, flat, batch)
        self.counts[how] += 1
        return self.fn(state, batch, generator) if out is None else out

    def _retire(self, generator: Optional[torch.Generator], dev: torch.device) -> None:
        """After a failed capture: the generator states the capture
        registered (the caller's and the card's default) stay in capture
        mode and the memory pool stays marked as recording, so each
        generator gets a fresh copy of its state, the next capture a new
        pool, and every graph (registered with the old states, in the old
        pool) goes: its key captures again on its next call."""
        gens = [generator] + ([torch.cuda.default_generators[dev.index or 0]]
                              if dev.type == "cuda" else [])
        for gen in gens:
            if gen is not None and gen.device.type == "cuda":
                gen.graphsafe_set_state(gen.clone_state())
        self._graphs.clear()
        self._pool = self._stream = None

    def _capture(self, flat: list, spec, batch: dict,
                 generator: Optional[torch.Generator]) -> _Graph:
        dev = next(iter(batch.values())).device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        if self._state_spec is None:
            self._state_bufs = [torch.empty_like(t) if isinstance(t, torch.Tensor) else t
                                for t in flat]
            self._state_spec = spec
        state_in = pytree.tree_unflatten(self._state_bufs, spec)
        batch_in = {k: torch.empty_like(v) for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        here = torch.cuda.current_stream(dev)
        self._stream.wait_stream(here)
        before = launch_counts()
        try:
            with torch.cuda.stream(self._stream):
                # thread_local: a trainer's prefetch thread may allocate and copy meanwhile
                graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    new_state, metrics = self.fn(state_in, batch_in, generator)
                    new_flat, new_spec = pytree.tree_flatten(new_state)
                    if new_spec != spec:
                        raise RuntimeError("the step's new state is shaped otherwise than its state")
                    _copy(_tensors(self._state_bufs), _tensors(new_flat))
                finally:
                    graph.capture_end()
            _upload(graph, self._stream)
        finally:
            counted = launches_since(before)    # no kernel ran
            add_launches(counted, -1)
        here.wait_stream(self._stream)
        out, out_spec = pytree.tree_flatten((state_in, metrics))
        return _Graph(graph, batch_in, out, out_spec, generator, counted)

    def _replay(self, g: _Graph, flat: list, batch: dict):
        _copy(_tensors(self._state_bufs) + list(g.batch.values()),
              _tensors(flat) + [batch[k] for k in g.batch])
        g.graph.replay()
        add_launches(g.launches)
        fresh = [torch.empty_like(t) if isinstance(t, torch.Tensor) else t for t in g.out]
        _copy(_tensors(fresh), _tensors(g.out))
        return pytree.tree_unflatten(fresh, g.out_spec)
