"""Captured programs: a scan, a batch or a revolution as one CUDA graph.

The reference runs its production mode as one compiled program: ``jit``
of the whole pipeline for each (capacity bucket, static settings,
attribute schema) (reference ``models/preprocessor.py``, ``build_pipeline``,
``_batched_pipeline`` and ``_seq_batched_pipeline``), and of decode,
pipeline and quantizer on the streaming path (reference
``io/streaming.py``). On a CUDA card the port captures the same unit as a
CUDA graph and replays it: one graph launch in place of 100-34,000
kernel launches dispatched one by one from the host.

A program is keyed by its caller's tag (the mode and the static settings)
and by the structure, shapes and dtypes of its tensor inputs (capacity,
attribute names and dtypes, batch shape): the reference's program
identity. ``program`` captures on the first call of a key:

1. static input tensors are allocated and filled from that call's inputs;
2. one warm-up run on a side stream builds what a first run builds (the
   kernel library, K3's function attributes, cuBLAS state, an NCCL
   communicator), outside the capture;
3. the capture records one run into the graph's own memory pool;
4. what the capture counted becomes the program's credits: the kernel
   launches (``ops._build.LAUNCHES``) and any counter the caller names
   (the sharded step's collectives). A replay does not pass through the
   kernels' wrappers or the collectives' counters, so every replay adds
   its credits; the warm-up's and the capture's own counts are taken
   back.

Capture and replay run under ``ops._build.device_guard`` of the inputs'
device, and capture on a stream of that device, so a program on
``cuda:1`` captures and replays there whatever device is current. The
capture's error mode is ``"thread_local"``: CUDA calls this thread must
not make during a capture still raise, while other threads' calls
(NCCL's watchdog querying its events, a pipelined node's worker) leave
the capture alone, as they would not under ``"global"``.

A call copies its inputs into the static ones (one ``torch._foreach_copy_``
a dtype), replays the graph on the current stream of its device and
returns clones of the outputs, so that the next replay cannot overwrite a
result a caller still holds. Numeric parameters are inputs too, so
``update_config``'s numeric changes and a new TF reach the graph with the
next call. Nothing inside a capture may read a device value on the host
or draw from a ``torch.Generator``: callers draw ahead
(``pipeline.draw_uniforms``). A failed capture or replay raises; nothing
falls back to eager execution.

The cache drops its least recently used programs while it holds more
than ``MAX_PROGRAMS`` programs, or while the graph pools of one device's
programs hold more than ``POOL_FRACTION`` of that device's memory (the
newest program always stays). An evicted program releases its graph; its
pool's memory goes back to the card only at ``torch.cuda.empty_cache``
(the caching allocator keeps a freed pool's segments until then), so an
eviction ends with that call.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..core.scan import ScanBuffer
from ..ops import _build
from .pipeline import PipelineParams

__all__ = [
    "MAX_PROGRAMS", "POOL_FRACTION", "CapturedProgram", "captures", "clear", "lookup", "program",
    "program_key", "programs",
]

#: programs kept, as the reference's ``lru_cache(maxsize=64)``
MAX_PROGRAMS = 64
#: the share of a card's memory the cached programs' graph pools may hold
#: together. The reference's compiled programs allocate their buffers per
#: call; a captured program keeps its pool for as long as it is cached
#: (production 170 MB, config 6 1.3 GB, a B=8 batch 1.6 GB). A quarter
#: leaves the rest of the card to the eager working set, the callers'
#: tensors and the next capture: on an 80 GB card, a dozen B=8 programs.
POOL_FRACTION = 0.25

pytree.register_pytree_node(
    ScanBuffer,
    lambda b: ([b.positions, b.mask, b.attributes], None),
    lambda children, _: ScanBuffer(*children),
)
_PARAM_FIELDS = [f.name for f in dataclasses.fields(PipelineParams)]
pytree.register_pytree_node(
    PipelineParams,
    lambda p: ([getattr(p, name) for name in _PARAM_FIELDS], None),
    lambda children, _: PipelineParams(*children),
)


def captures(device: torch.device) -> bool:
    """Whether the engines run captured programs on ``device``: on a CUDA
    card always (no switch, as the reference's ``jit`` has none); on the
    CPU they run eagerly."""
    return device.type == "cuda"


def _capture(fn: Callable, device: torch.device):
    """Warm up ``fn()`` on a side stream of ``device``, then capture one run
    on another stream of it into a graph with its own memory pool, all
    under the device's guard. Returns (graph, outputs, pool bytes)."""
    with _build.device_guard(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no pool given: a private one
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                              capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(device)
            outputs = fn()
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return graph, outputs, pool_bytes


class CapturedProgram:
    """One captured run of ``fn(*args)`` (see the module docstring).

    ``counters``: dicts of host-side counts, besides the kernel launches,
    that ``fn`` adds to and a replay credits.

    Attributes: ``device``, ``credits`` (kernel launches a replay makes),
    ``capture_ms`` (host ms of the warm-up and the capture), ``pool_bytes``
    (device memory the capture reserved for its pool), ``replays``.
    """

    def __init__(self, fn: Callable, args: tuple, device: torch.device,
                 counters: Sequence[Dict[str, int]] = ()):
        self.device = device
        leaves, self._spec = _flatten(args)
        t0 = time.perf_counter()
        self.static = [
            None if t is None else torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in leaves
        ]
        by_dtype: Dict[torch.dtype, List[int]] = collections.defaultdict(list)
        for i, t in enumerate(leaves):
            if t is not None:
                by_dtype[t.dtype].append(i)
        self._groups = list(by_dtype.values())
        self._fill(leaves)
        counters = (_build.LAUNCHES, *counters)
        saved = [dict(c) for c in counters]
        self._fn = fn  # kept: the tensors it closes over stay alive
        static_args = pytree.tree_unflatten(self.static, self._spec)

        def counted():
            before = [dict(c) for c in counters]
            out = fn(*static_args)
            return out, [{k: c[k] - b[k] for k in b} for c, b in zip(counters, before)]

        graph, (outputs, deltas), self.pool_bytes = _capture(counted, device)
        for c, s in zip(counters, saved):
            c.update(s)  # set-up, not a run
        self._graph = graph
        self.credits = deltas[0]
        self._credits = list(zip(counters, deltas))
        self._outputs, self._out_spec = pytree.tree_flatten(outputs)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.replays = 0

    def _fill(self, leaves) -> None:
        for idx in self._groups:
            torch._foreach_copy_([self.static[i] for i in idx], [leaves[i] for i in idx])

    def __call__(self, *args, clone: bool = True):
        """Replay on ``args`` (the structure, shapes and dtypes of the
        capture's). ``clone=False`` returns the graph's own output tensors,
        which the next replay overwrites: only for a caller that consumes
        them on the current stream before that."""
        with _build.device_guard(self.device):
            self._fill(_flatten(args)[0])
            self._graph.replay()
        for counter, delta in self._credits:
            for k, n in delta.items():
                counter[k] += n
        self.replays += 1
        outs = self._outputs
        if clone:  # a stage without a plane returns None beside its buffer
            outs = [None if o is None else o.clone() for o in outs]
        return pytree.tree_unflatten(outs, self._out_spec)


_PROGRAMS: "collections.OrderedDict[tuple, CapturedProgram]" = collections.OrderedDict()


def _flatten(args):
    """(leaves, spec) of nested inputs whose leaves are tensors or None."""
    leaves, spec = pytree.tree_flatten(args, is_leaf=lambda x: x is None)
    for t in leaves:
        if t is not None and not isinstance(t, torch.Tensor):
            raise TypeError(f"captured program inputs must be tensors, got {type(t).__name__}")
    return leaves, spec


def program_key(tag, args) -> tuple:
    """A program's identity: the caller's tag, the inputs' structure (None
    draws, attribute names) and each tensor's shape, dtype and device."""
    leaves, spec = _flatten(args)
    return (tag, repr(spec), tuple(
        None if t is None else (tuple(t.shape), t.dtype, t.device) for t in leaves))


def program(tag, make_fn: Callable[[], Callable], *args,
            counters: Sequence[Dict[str, int]] = ()) -> CapturedProgram:
    """The captured program of ``tag`` for inputs shaped as ``args``;
    ``make_fn()`` gives the function to capture on a miss, which then
    captures it on ``args`` (crediting ``counters`` on every replay, see
    ``CapturedProgram``). The tag must fix everything the function does
    that is not in its inputs."""
    key = program_key(tag, args)
    found = _PROGRAMS.get(key)
    if found is not None:
        _PROGRAMS.move_to_end(key)
        return found
    device = next(t for t in _flatten(args)[0] if t is not None).device
    prog = CapturedProgram(make_fn(), args, device, counters)
    _PROGRAMS[key] = prog
    _evict(device)
    return prog


def _evict(device: torch.device) -> None:
    """Drop least recently used programs, the newest excepted, while the
    cache holds more than ``MAX_PROGRAMS`` or the pools of ``device``'s
    programs more than ``POOL_FRACTION`` of its memory; then hand the freed
    pools back to the card (see the module docstring)."""
    budget = POOL_FRACTION * torch.cuda.mem_get_info(device)[1]
    held = sum(p.pool_bytes for p in _PROGRAMS.values() if p.device == device)
    evicted = False
    for key in list(_PROGRAMS)[:-1]:
        mine = _PROGRAMS[key].device == device
        if len(_PROGRAMS) > MAX_PROGRAMS or (mine and held > budget):
            # no name keeps the dropped program: its pool is freed here
            pool_bytes = _PROGRAMS.pop(key).pool_bytes
            held -= pool_bytes if mine else 0
            evicted = True
    if evicted:
        torch.cuda.empty_cache()


def programs() -> List[CapturedProgram]:
    """The cached programs, least recently used first."""
    return list(_PROGRAMS.values())


def clear() -> None:
    """Drop every cached program (their graphs and pools with them)."""
    _PROGRAMS.clear()


def lookup(tag, args) -> Optional[CapturedProgram]:
    """The cached program for ``tag`` and inputs shaped as ``args``, or
    None (no capture)."""
    return _PROGRAMS.get(program_key(tag, args))
