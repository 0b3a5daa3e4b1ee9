"""Stage graphs: a codec's calls replayed as captured CUDA graphs, one
graph per stage.

A codec's ``encode`` and ``decode`` walk a fixed sequence of stages, the
spans of :mod:`.profiling` (``codec.stft``, ``encoder.*``, ``vq.*``,
``decoder.*``, ``codec.istft``), each written as ``stage(name, fn,
*args)``. With no chain active, a stage is ``fn(*args)`` inside its span.
For a repeated call on a CUDA device the codec keeps a *chain* instead:
one ``torch.cuda.CUDAGraph`` per stage, every graph of every chain of the
codec in one memory pool. :class:`StageGraphs` decides per call key (the
codec's ``encode``: batch, length, streams and compute dtype; ``decode``:
the codes' shape and dtype, ``feat_shape`` and compute dtype):

- a key's first call runs eagerly, as without graphs: it builds the
  lazily cached masks, DFT matrices and launch plans;
- its second call runs eagerly too, which serves it and leaves every
  constant it reads in its cache, then copies its input into the chain's
  static buffer and captures the stages in order on a side stream (one
  synchronisation a chain; ``codec.capture``);
- later calls copy the input into that buffer and replay
  (``codec.replay``): the same Python walks the same stages, each of
  which launches its graph inside its own span and returns the outputs
  it recorded, so every kernel keeps its stage's span. A walk that leaves
  the recorded sequence of stage names raises.

Replay gains only where a call's exact key repeats: a serving loop over a
few lengths, a batch server's one shape, ``encode_chunked``'s full
chunks. A capture costs about an eager call more and a replay saves most
of one, so a chain must be replayed to pay. A codec keeps at most
:data:`MAX_CHAINS` chains and remembers the last :data:`SEEN` keys
called once; calls whose keys do not come back within :data:`SEEN` calls
never capture. Once the chains are full, a key's second call captures
only in the place of the least recently used chain, and only where that
chain has gone unused for :data:`SEEN` calls and the chain that took the
last place so freed has been replayed or was captured :data:`SEEN` calls
ago; otherwise the call runs eagerly. So keys that recur more than the
chains hold keep the chains there are, and a mix that moves on to other
keys takes the places of the old ones one by one: captures stay a small
share of the calls whatever the mix.

A stage's inputs are the chain's input buffer or earlier stages' outputs,
all kept by the chain, so they are static by construction; the call's
result is cloned out of the pool, so the caller may keep it across calls.
The chains share one pool: memory that one chain's graphs use only
within a stage another chain's may use too. That holds because a replay
runs every stage of its chain, in order, from the static input, and its
result is cloned before another chain runs: the calls take turns under
the codec's lock, and each waits on the device for the one before it,
whatever stream either ran on. So no chain keeps anything in the pool
from one call to the next but the outputs its graphs write anew.

A capture that fails (an operator that cannot be captured) leaves the key
eager for good; the call was served by its eager run. One lock a codec
covers its chains: calls from several threads take turns at the captures
and replays, and their eager calls run side by side as before.

Lifetimes. A graph reads device memory outside its pool: the parameters
and buffers, and the constants that :func:`hold` hands to the capturing
chain (``modules/transformer.py::_mask_on``, ``ops/stft.py::_on_device``),
which the chain keeps alive whatever their caches evict. Every call
compares the address of each parameter and buffer of the module, in
order, and the module's tree, with those the chains were captured on,
and drops the chains where one differs: a tensor replaced, registered or
given memory of its own (``module.to``, a submodule's ``half()``,
``p.data = ...``, ``set_``). A tensor converted so gets its new memory
while the old one still lives, so its address changes; where it lands
again on the address it had at the capture, the graphs read its current
values there. Weights loaded in place (``load_state_dict``) are read by
the next replay, as eagerly. The bf16 casts of the Linear weights are
made inside the graphs, so they follow the weights too.

Kernel counters. Each wrapper of :data:`~esc_tpu_torch.ops.kernels.
KERNELS` counts the launches it makes in ``launches``: an eager call's,
and a capture's (each kernel is put into its graph by one call of its
wrapper). A replay calls no wrapper and counts nothing there; each chain
counts its replays in ``replays`` and keeps in ``kernels`` the launches
of each kernel that one replay makes, as its capture counted them.
"""

from __future__ import annotations

import itertools
import threading
import warnings
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.kernels import KERNELS
from .profiling import annotate

__all__ = ["stage", "hold", "capturing", "StageGraphs", "MAX_CHAINS", "SEEN"]

MAX_CHAINS = 64             # chains a codec keeps (a serving loop: 48)
SEEN = 4 * MAX_CHAINS       # keys remembered, and calls a chain sits unused
                            # before a new key's chain may take its place

_ACTIVE = threading.local()  # .chain: the chain this thread walks, if any


def _values(dicts: list):
    """The values of ``dicts``, in order."""
    return itertools.chain.from_iterable(map(dict.values, dicts))


def stage(name: str, fn: Callable[..., Any], *args) -> Any:
    """``fn(*args)`` inside the span ``name``; in a chain's capture, one
    graph; in its replay, that graph's launch and its recorded outputs."""
    chain = getattr(_ACTIVE, "chain", None)
    if chain is None:
        with annotate(name):
            return fn(*args)
    return chain.stage(name, fn, args)


def hold(t: torch.Tensor) -> torch.Tensor:
    """``t``, kept alive by the chain that is capturing, if any: a cached
    device constant that the chain's graphs read."""
    chain = getattr(_ACTIVE, "chain", None)
    if chain is not None and chain.capturing:
        chain.held.append(t)
    return t


def capturing() -> bool:
    """Whether this thread is capturing a chain."""
    chain = getattr(_ACTIVE, "chain", None)
    return chain is not None and chain.capturing


class _Chain:
    """The graphs of one call key: a graph, a stage name and the recorded
    outputs per stage, the static input, the constants the graphs read,
    the kernels' launches a replay makes and the replays made."""

    def __init__(self, static_input: torch.Tensor, pool):
        self.input = static_input
        self.pool = pool
        self.names: List[str] = []
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.outputs: List[Any] = []
        self.held: List[torch.Tensor] = []
        self.kernels: Dict[str, int] = {}
        self.replays = 0
        self.last = 0               # the codec's call that used it last
        self.result = None
        self.capturing = False
        self.step = 0

    def stage(self, name: str, fn, args) -> Any:
        if not self.capturing:
            i = self.step
            if i >= len(self.names) or self.names[i] != name:
                raise RuntimeError(
                    f"stage walk left its graphs: {name!r} as stage {i} of "
                    f"{self.names}")
            self.step = i + 1
            with annotate(name):
                self.graphs[i].replay()
            return self.outputs[i]
        graph = torch.cuda.CUDAGraph()
        with annotate(name):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = fn(*args)
            finally:
                graph.capture_end()
        self.names.append(name)
        self.graphs.append(graph)
        self.outputs.append(out)
        return out

    def capture(self, fn: Callable[[torch.Tensor], torch.Tensor],
                side: torch.cuda.Stream) -> None:
        """Capture ``fn(self.input)`` stage by stage on the stream
        ``side``; nothing runs on the device."""
        with annotate("codec.capture"):
            torch.cuda.synchronize(self.input.device)
            before = {name: w.launches for name, (w, _) in KERNELS.items()}
            side.wait_stream(torch.cuda.current_stream(self.input.device))
            self.capturing = True
            _ACTIVE.chain = self
            try:
                with torch.cuda.stream(side):
                    out = fn(self.input)
            finally:
                _ACTIVE.chain = None
                self.capturing = False
            self.kernels = {name: KERNELS[name][0].launches - n
                            for name, n in before.items()
                            if KERNELS[name][0].launches != n}
            last = self.outputs[-1] if self.outputs else None
            if not (out is last or (isinstance(last, tuple)
                                    and any(out is o for o in last))):
                raise RuntimeError("the call's result is no stage's output")
            self.result = out

    def replay(self, fn: Callable[[torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
        """Walk ``fn`` over the recorded stages, launching each graph: the
        call's result, cloned."""
        with annotate("codec.replay"):
            self.step = 0
            _ACTIVE.chain = self
            try:
                out = fn(self.input)
            finally:
                _ACTIVE.chain = None
            if self.step != len(self.graphs) or out is not self.result:
                raise RuntimeError(
                    f"stage walk left its graphs after {self.step} of "
                    f"{self.names}")
            self.replays += 1
            return out.clone()


class StageGraphs:
    """A codec's chains, by call key, for ``module`` (see the module
    docstring for the policy). The codec makes one where its calls may
    replay graphs: on a CUDA device, with the kernels, in eval mode."""

    def __init__(self, module: nn.Module, device: torch.device):
        self.module = module
        self.device = device
        self._lock = threading.Lock()
        self._side: Optional[torch.cuda.Stream] = None    # captures
        self._pool = None                                 # every chain's
        self._done: Optional[torch.cuda.Event] = None     # the last call's
        self.chains: "OrderedDict[Hashable, _Chain]" = OrderedDict()
        # key -> True (seen once: the next call may capture) or False (eager)
        self.seen: "OrderedDict[Hashable, bool]" = OrderedDict()
        self.calls = 0
        self._fresh: Optional[_Chain] = None    # the last to make way
        self._walk()
        self.weights = self._weights_key()

    def _walk(self) -> None:
        """Cache the dicts of the module's tree that hold something: of
        submodules, and of parameters and buffers. A tensor or submodule
        that lands in one that was empty is none that the graphs read."""
        owners = list(self.module.modules())
        self._subs = [m._modules for m in owners if m._modules]
        self._own = [d for m in owners for d in (m._parameters, m._buffers)
                     if d]
        self._tree = tuple(_values(self._subs))
        self._entries: tuple = ()

    def _weights_key(self) -> tuple:
        """What the chains stay valid for: the module's tree (every
        submodule, parameter and buffer, in order) and the address of each
        parameter and buffer. The tree is walked again only where one of
        its submodules was replaced or added."""
        if tuple(_values(self._subs)) != self._tree:
            self._walk()
        entries = tuple(map(id, _values(self._own)))
        if entries != self._entries:    # the tensors kept: no id is reused
            self._entries = entries
            self._tensors = [t for t in _values(self._own) if t is not None]
        return (self._tree, entries,
                tuple(map(torch.Tensor.data_ptr, self._tensors)))

    def call(self, key: Hashable, shape: Tuple[int, ...], dtype: torch.dtype,
             upload: Callable[[Optional[torch.Tensor]], torch.Tensor],
             fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``fn`` of the call's input on the device. ``upload(None)``
        returns the input on the device, ``upload(buffer)`` copies it into
        ``buffer`` (of ``shape`` and ``dtype``)."""
        with self._lock:
            self.calls += 1
            weights = self._weights_key()
            if weights != self.weights:
                self._drop(list(self.chains.values()))
                self.chains.clear()
                self.weights = weights
            chain = self.chains.get(key)
            if chain is not None:
                self.chains.move_to_end(key)
                chain.last = self.calls
                self._done_before()
                upload(chain.input)
                out = chain.replay(fn)
                self._done.record()
                return out
            seen = self.seen.pop(key, None)
            room = self._room() if seen else False
            if room is not False:
                return self._capture(key, shape, dtype, upload, fn,
                                     taken=room is None)
            self.seen[key] = seen is not False
            if len(self.seen) > SEEN:
                self.seen.popitem(last=False)
        return fn(upload(None))     # eager, outside the lock

    def _room(self) -> Optional[bool]:
        """Whether a new chain may be kept: there is room (True), or the
        least recently used chain has gone unused for :data:`SEEN` calls
        and the chain that took the last place made way for has been
        replayed, or captured :data:`SEEN` calls ago; then the least
        recently used makes way (None)."""
        if len(self.chains) < MAX_CHAINS:
            return True
        key, lru = next(iter(self.chains.items()))
        fresh = self._fresh
        if self.calls - lru.last < SEEN or (
                fresh is not None and not fresh.replays
                and self.calls - fresh.last < SEEN):
            return False
        del self.chains[key]
        self._drop([lru])
        return None

    def _done_before(self) -> None:
        """Have the current stream wait for the chains' last call."""
        if self._done is None:
            self._done = torch.cuda.Event()
        else:
            torch.cuda.current_stream(self.device).wait_event(self._done)

    def _capture(self, key, shape, dtype, upload, fn, taken: bool
                 ) -> torch.Tensor:
        """Serve the call eagerly, then capture its chain (which runs
        nothing on the device); ``taken``: in a place another made way
        for."""
        x = upload(None)
        out = fn(x)         # every constant the call reads is cached now
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        chain = _Chain(torch.empty(shape, dtype=dtype, device=self.device)
                       .copy_(x), self._pool)
        try:
            chain.capture(fn, self._side)
        except Exception as err:    # the call is served all the same
            self.seen[key] = False
            warnings.warn(f"stage graphs of {key} not captured, the calls "
                          f"run eagerly: {err!r}", RuntimeWarning)
            return out
        chain.last = self.calls
        self.chains[key] = chain
        if taken:
            self._fresh = chain
        return out

    def _drop(self, chains: list) -> None:
        """Let the graphs' launches finish before their memory goes."""
        if chains:
            torch.cuda.synchronize(self.device)
        chains.clear()
