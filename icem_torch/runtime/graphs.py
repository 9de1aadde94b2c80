"""Compiled steps: a step captured once per fixed shape as a CUDA graph and
replayed, the port's counterpart of ``jax.jit``.

The JAX package compiles each controller step (``MpcICem._plan`` and
``_advance``, ``icem_tpu/controllers/icem.py:543-546``, and the same two in
``cem_std.py``), the fused episode's chunk (``chunk_fn``,
``icem_tpu/runtime/rollout.py:298-310``) and the host loop's env step
(``jax.jit(env.step)``, ``rollout.py:140``) into one device program each.
Here ``Compiled(fn)`` captures ``fn`` as one ``torch.cuda.CUDAGraph`` per key
and replays it:

- The arguments are split into leaves (``torch.utils._pytree``). Tensors are
  inputs, copied into the graph's static buffers before each replay;
  generators are state (below); every other leaf (a bool, an int, None) is
  static. The key holds the trees' structure, the static leaves, each input's
  shape, stride, dtype and device, and the ``data_ptr`` of the tensors that
  the graph reads where they lie: the arguments at ``in_place`` (a learned
  model's weights, which an optimizer updates in place) and the tensors that
  ``reads()`` names. New weight tensors therefore make a new capture, never a
  replay on stale pointers.
- On a miss: static buffers, one warm-up call on a side stream, which fills
  every lazy device constant (a copy from the host cannot be captured), then
  the capture, with ``capture_error_mode="thread_local"``. A capture that
  fails raises; nothing falls back to eager. A host wait inside ``fn``
  (``Tensor.item``, a 0-d index tensor, a copy from the host) is such a
  failure.
- Generators: a graph draws from the generator states registered with it.
  Each generator argument gets a generator of the graph's own, which takes
  the caller's state before a replay and hands it back after, so the
  caller's generator advances as an eager call would advance it, whichever
  generator (a new episode's, a restored checkpoint's) the caller passes.
  Generators that ``fn`` reaches through its closure (a learned model's,
  from ``reads()``) are registered as they are.
- Outputs are copied out of the graph's memory after each replay, one copy
  per dtype, so the next replay does not overwrite them. Outputs that are
  not tensors are the capture's: they depend on the static leaves alone.
- Counters (``runtime/metrics.py``): the kernels count their launches and
  rows in Python calls, which a replay does not make. Each graph records
  what its capture counted and adds it on every replay, so the counts equal
  an eager run's. ``graphs.captures``, ``graphs.capture_s`` (warm-up
  included) and ``graphs.replays`` count the graphs' own activity.
- Phase markers: a capture keeps the graph (``keep_graph=True``), and the
  marker kernels the step launched (``metrics.phase``) stay in it as
  disabled nodes. A replay enables them while tracing is active and
  disables them once it is not: no recapture, no new key.
- The garbage collector is paused during a capture (``_collector_paused``):
  CUDA refuses to destroy a kept graph while a stream captures.
- Spans: ``graphs.capture:<name>`` around a capture, ``graphs.replay:<name>``
  around every call (copy-in, replay, output copies).

On the CPU there is no graph: the same buffer plumbing (copy in, call,
outputs out) calls ``fn`` on the static buffers. ``disable_graphs()``, the
counterpart of ``jax.disable_jit()``, runs every compiled step eagerly on the
caller's tensors. A compiled step called inside another one's warm-up or
capture runs inline, as a jitted function does inside a jitted one.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from icem_torch.runtime import metrics

# seconds spent capturing (warm-up included): the store's graphs.capture_s,
# kept under this name for readers of the module value
CAPTURE_SECONDS = 0.0

_local = threading.local()


def graphs_enabled() -> bool:
    """False inside ``disable_graphs()``."""
    return getattr(_local, "disabled", 0) == 0


@contextlib.contextmanager
def disable_graphs():
    """Run every compiled step eagerly, on the card as on the CPU, until the
    block ends (nests)."""
    _local.disabled = getattr(_local, "disabled", 0) + 1
    try:
        yield
    finally:
        _local.disabled -= 1


@contextlib.contextmanager
def _inline():
    """Compiled steps called in this block run their function directly."""
    _local.inline = getattr(_local, "inline", 0) + 1
    try:
        yield
    finally:
        _local.inline -= 1


@contextlib.contextmanager
def _collector_paused():
    """No automatic cyclic garbage collection inside. A controller and its
    compiled steps form a reference cycle, so the collector frees their
    graphs at whatever allocation comes next; freeing a kept graph while a
    stream captures is an operation CUDA refuses, and the capture fails."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def _pack(out):
    """The outputs' tensors as one flat tensor per dtype, and how to take
    them apart again (``_unpack``)."""
    leaves, spec = pytree.tree_flatten(out)
    groups: dict = {}
    plan = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            group = groups.setdefault(x.dtype, [])
            start = sum(t.numel() for t in group)
            plan.append(("t", x.dtype, start, tuple(x.shape)))
            group.append(x)
        else:
            plan.append(("v", x))
    dtypes = list(groups)
    flats = [torch.cat([t.reshape(-1) for t in groups[d]]) for d in dtypes]
    return flats, (dtypes, plan, spec)


def _unpack(flats, layout, generators: dict):
    """The outputs from ``_pack``'s flat tensors; a generator of the graph's
    own is handed back as the caller's (``generators``)."""
    dtypes, plan, spec = layout
    flat_of = dict(zip(dtypes, flats))
    leaves = []
    for item in plan:
        if item[0] == "t":
            _, dtype, start, shape = item
            n = 1
            for s in shape:
                n *= s
            leaves.append(flat_of[dtype][start: start + n].view(shape))
        else:
            leaves.append(generators.get(id(item[1]), item[1]))
    return pytree.tree_unflatten(leaves, spec)


class _Entry:
    """One key's graph: its static inputs, its own generators, the arguments
    it was captured with and its outputs."""

    def __init__(self, args, inputs, owned, closure_generators):
        self.args = args                  # the call's arguments over the buffers
        self.inputs = inputs              # static input buffers, in leaf order
        self.owned = owned                # one generator per generator argument
        self.closure_generators = closure_generators
        self.graph = None                 # the CUDA graph (None on the CPU)
        self.flats = None                 # its packed outputs
        self.layout = None
        self.counts = {}                  # counter growth per replay
        self.markers = None               # the graph's marker nodes, if any
        self.markers_on = False


class Compiled:
    """``fn`` captured as a CUDA graph per key and replayed (see the module).

    ``in_place``: positions of the arguments whose tensors the graph reads
    where they lie instead of copying them in (weights). ``reads``: a
    function that returns the tensors and generators ``fn`` reaches through
    its closure. All graphs of one ``Compiled`` share one memory pool: they
    replay one at a time on one stream, and their outputs are copied out.
    """

    def __init__(self, fn: Callable, *, in_place: tuple = (), reads: Optional[Callable] = None,
                 name: Optional[str] = None):
        self.fn = fn
        self.in_place = frozenset(in_place)
        self.reads = reads
        self.name = name or getattr(fn, "__qualname__", None) or repr(fn)
        self._entries: dict = {}
        self._pool = None
        self._replay_span = f"graphs.replay:{self.name}"
        self._capture_span = f"graphs.capture:{self.name}"

    @property
    def num_keys(self) -> int:
        """The keys seen: on the card, the graphs captured."""
        return len(self._entries)

    def __call__(self, *args):
        if not graphs_enabled() or getattr(_local, "inline", 0):
            return self.fn(*args)
        key, tensors, generators, rebuilt, closure_generators = self._split(args)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._new_entry(tensors, generators, rebuilt, closure_generators)
            self._entries[key] = entry
        return self._run(entry, tensors, generators)

    # -- keys ---------------------------------------------------------------
    def _split(self, args):
        """(key, input tensors, generator arguments, the arguments' leaves and
        structures, closure generators)."""
        key, tensors, generators, rebuilt = [], [], [], []
        for i, arg in enumerate(args):
            leaves, spec = pytree.tree_flatten(arg)
            key.append(spec)
            for x in leaves:
                if isinstance(x, torch.Tensor):
                    if i in self.in_place:
                        key.append(("w", x.data_ptr(), tuple(x.shape), x.dtype, x.device))
                    else:
                        key.append(("t", tuple(x.shape), x.stride(), x.dtype, x.device))
                        tensors.append(x)
                elif isinstance(x, torch.Generator):
                    if i in self.in_place:
                        raise TypeError(f"{self.name}: argument {i} is read in place and holds "
                                        f"a generator; pass generators as other arguments")
                    key.append(("g", x.device))
                    generators.append(x)
                else:
                    key.append((type(x), x))
            rebuilt.append((leaves, spec, i in self.in_place))
        closure_generators = []
        if self.reads is not None:
            for x in pytree.tree_leaves(self.reads()):
                if isinstance(x, torch.Generator):
                    key.append(("cg", id(x)))
                    closure_generators.append(x)
                elif isinstance(x, torch.Tensor):
                    key.append(("cw", x.data_ptr(), tuple(x.shape), x.dtype, x.device))
        return tuple(key), tensors, generators, rebuilt, closure_generators

    # -- a miss -------------------------------------------------------------
    def _new_entry(self, tensors, generators, rebuilt, closure_generators) -> _Entry:
        inputs = [x.clone() for x in tensors]
        owned = [torch.Generator(device=g.device) for g in generators]
        it_in, it_gen = iter(inputs), iter(owned)
        args = []
        for leaves, spec, in_place in rebuilt:
            if not in_place:
                leaves = [next(it_in) if isinstance(x, torch.Tensor)
                          else next(it_gen) if isinstance(x, torch.Generator) else x
                          for x in leaves]
            args.append(pytree.tree_unflatten(leaves, spec))
        entry = _Entry(tuple(args), inputs, owned, closure_generators)
        devices = {x.device for x in tensors} | {g.device for g in generators}
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:
            self._capture(entry, generators, cuda[0])
        return entry

    def _capture(self, entry: _Entry, generators, device):
        """Warm up, then capture ``fn`` on the entry's buffers. The counters
        are left as they were: replays add the capture's."""
        global CAPTURE_SECONDS
        t0 = time.perf_counter()
        with metrics.span(self._capture_span):
            self._capture_graph(entry, generators, device)
        metrics.count("graphs.captures")
        metrics.count("graphs.capture_s", time.perf_counter() - t0)
        CAPTURE_SECONDS = metrics.counter("graphs.capture_s")

    def _capture_graph(self, entry: _Entry, generators, device):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in entry.owned + entry.closure_generators:
            graph.register_generator_state(g)
        index = device.index if device.index is not None else torch.cuda.current_device()
        kept = [(g, g.get_state())
                for g in entry.closure_generators + [torch.cuda.default_generators[index]]]
        for own, g in zip(entry.owned, generators):
            own.set_state(g.get_state())
        before = metrics.counters()
        try:
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side), _inline():
                self.fn(*entry.args)
            stream.wait_stream(side)
            # the warm-up drew from the closure's generators: the first
            # replay draws what an eager call would
            for g, state in kept:
                g.set_state(state)
            warm = metrics.counters()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            try:
                with _inline(), _collector_paused(), metrics.capturing() as cap, \
                        torch.cuda.graph(graph, pool=self._pool,
                                         capture_error_mode="thread_local"):
                    flats, layout = _pack(self.fn(*entry.args))
            except RuntimeError as e:
                raise RuntimeError(
                    f"CUDA graph capture of {self.name} failed: {e}. A captured step may "
                    f"not wait for the card (Tensor.item, a 0-d index tensor, a copy from "
                    f"the host); disable_graphs() runs it eagerly") from e
            captured = metrics.counters()
        finally:
            for k, n in metrics.since(before).items():
                metrics.count(k, -n)
        entry.counts = metrics.since(warm, captured)
        if entry.counts != metrics.since(before, warm):
            raise RuntimeError(f"{self.name}: the capture counted otherwise than the "
                               f"warm-up ({entry.counts} against {metrics.since(before, warm)})")
        graph.instantiate()
        entry.markers = metrics.graph_markers(graph, cap)
        entry.graph, entry.flats, entry.layout = graph, flats, layout

    # -- every call ---------------------------------------------------------
    def _run(self, entry: _Entry, tensors, generators):
        with metrics.span(self._replay_span):
            for own, g in zip(entry.owned, generators):
                own.set_state(g.get_state())
            if entry.inputs:
                torch._foreach_copy_(entry.inputs, tensors)
            if entry.graph is None:
                flats, layout = _pack(self.fn(*entry.args))
            else:
                if entry.markers is not None and entry.markers_on != metrics.active():
                    entry.markers_on = not entry.markers_on
                    metrics.set_graph_markers(entry.graph, entry.markers, entry.markers_on)
                entry.graph.replay()
                metrics.count("graphs.replays")
                for k, n in entry.counts.items():
                    metrics.count(k, n)
                flats, layout = [f.clone() for f in entry.flats], entry.layout
            for own, g in zip(entry.owned, generators):
                g.set_state(own.get_state())
            return _unpack(flats, layout,
                           {id(own): g for own, g in zip(entry.owned, generators)})

