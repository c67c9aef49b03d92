"""The port's jit layer: one CUDA graph per fixed-shape step.

The reference compiles each fixed-shape serving step into one XLA program
(``jax.jit``: the frame stages per bucket, the paged decode tick, the
cascade tick per metadata bucket) and counts the programs
(``_cache_size()``).  Here the counterpart of such a program is a captured
``torch.cuda.CUDAGraph``: the step's launches are recorded once and
replayed, with the inputs refilled in place, so the host issues one graph
launch where it issued every operation.

:class:`CapturedStep` keys a step on its inputs' shapes and dtypes, as jit
specializes, and owns each key's static input buffers.  On a CUDA device
the first call of a key runs ``fn`` eagerly on those buffers (the warm-up a
capture needs, and that call's real result), then captures ``fn`` into a
graph; every later call refills the buffers and replays the graph on the
current stream.  On the CPU, which only a caller asking for the CPU gets,
every call runs ``fn`` on the same buffers, as it does on a card for a step
made with ``capture=False`` (a sharded slice whose shards live on distinct
cards: one graph records one device's work).  A capture or replay that
fails raises; nothing falls back to running the step eagerly.

An owner's steps share one :class:`GraphPool`.  What a graph freezes at
capture, and so what must not change under it:
the addresses of everything ``fn`` reads besides its inputs (weights, the
paged arena), the values of Python-side state it reads (the kernels' split
plans read module constants such as ``paged_attn.MIN_CTAS``), and the
memory of its outputs, which the next replay of any step sharing the
owner's memory pool overwrites.

Python's cyclic garbage collector stays off while a graph is captured
(after one collection just before): a dropped owner whose steps sit in a
reference cycle would otherwise free its graphs in the middle of another
capture, which CUDA refuses, invalidating that capture.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from repro_torch import kernels

ALIGN = 16          # bytes: every static input starts 16-byte aligned


class GraphPool:
    """One owner's graph memory pool on ``device`` (no pool on the CPU).
    Steps that share a pool reuse each other's intermediates: each
    replay's outputs are read before the next replay of any step on the
    pool.  A capture that fails leaves its pool refusing every later
    capture (the caching allocator still counts it as recording), so the
    failing step moves the owner to a fresh pool (:meth:`renew`); the
    graphs captured before keep theirs."""

    def __init__(self, device: torch.device):
        self.handle = None
        if torch.device(device).type == "cuda":
            self.renew()

    def renew(self) -> None:
        self.handle = torch.cuda.graph_pool_handle()


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.zeros(0, x.dtype)).dtype


@dataclasses.dataclass
class _Entry:
    """One key's static buffers and, once captured, its graph."""
    inputs: tuple[torch.Tensor, ...]    # views of ``buffer``
    buffer: torch.Tensor                # uint8 on the step's device
    staging: torch.Tensor               # pinned uint8 (``buffer`` on CPU)
    spans: tuple[slice, ...]            # each input's bytes in both
    copied: torch.cuda.Event | None = None  # after the last staging copy
                                            # (None on the CPU: no copy)
    ran: bool = False
    graph: torch.cuda.CUDAGraph | None = None
    outputs: object = None
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


class CapturedStep:
    """A fixed-shape step ``fn(*inputs)`` of tensors, captured once per key
    of input shapes and dtypes on a CUDA ``device`` (see the module
    docstring).

    Inputs are torch tensors or numpy arrays.  Numpy inputs reach the
    device in one copy from a pinned staging buffer per call; tensors are
    copied into their buffers on the device.  ``fn`` reads only its
    arguments besides state that stays put (it must not hold the owner, so
    an owner that drops its steps frees their graphs).

    The wrappers count their launches in Python, which a replay never
    runs: at capture each counter's delta is recorded and taken back
    (capture executes nothing), and every replay adds it once
    (:data:`repro_torch.kernels.COUNTERS`)."""

    def __init__(self, fn, device: torch.device,
                 pool: GraphPool | None = None, capture: bool = True):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture
        self.pool = pool if pool is not None else GraphPool(self.device)
        self._entries: dict[tuple, _Entry] = {}
        self._stream = None

    def _cache_size(self) -> int:
        """Keys run so far: the reference's jit cache entries, counted the
        same way (``obs.RecompileDetector`` reads it)."""
        return sum(e.ran for e in self._entries.values())

    def _new_entry(self, key: tuple) -> _Entry:
        spans, n = [], 0
        for shape, dtype in key:
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            spans.append(slice(n, n + nbytes))
            n += -(-nbytes // ALIGN) * ALIGN
        buffer = torch.empty(n, dtype=torch.uint8, device=self.device)
        inputs = tuple(buffer[s].view(dtype).view(shape)
                       for s, (shape, dtype) in zip(spans, key))
        if self.device.type == "cpu":
            entry = _Entry(inputs, buffer, buffer, tuple(spans))
        else:
            entry = _Entry(inputs, buffer,
                           torch.empty(n, dtype=torch.uint8, pin_memory=True),
                           tuple(spans), torch.cuda.Event())
        self._entries[key] = entry
        return entry

    def _load(self, inputs: tuple) -> _Entry:
        for x in inputs:
            if not isinstance(x, (torch.Tensor, np.ndarray)):
                raise TypeError(f"a captured step takes tensors and numpy "
                                f"arrays, got {type(x).__name__}")
        key = tuple((tuple(x.shape), _torch_dtype(x)) for x in inputs)
        entry = self._entries.get(key) or self._new_entry(key)
        host = [i for i, x in enumerate(inputs) if isinstance(x, np.ndarray)]
        if host:
            if entry.copied is not None:
                # the previous call's copy must have left the staging
                # buffer before the host writes it again
                entry.copied.synchronize()
            staged = entry.staging.numpy()
            for i in host:
                staged[entry.spans[i]] = np.ascontiguousarray(
                    inputs[i]).reshape(-1).view(np.uint8)
            if entry.copied is not None:
                lo = min(entry.spans[i].start for i in host)
                hi = max(entry.spans[i].stop for i in host)
                entry.buffer[lo:hi].copy_(entry.staging[lo:hi],
                                          non_blocking=True)
                entry.copied.record()
        for static, x in zip(entry.inputs, inputs):
            if isinstance(x, torch.Tensor):
                static.copy_(x)
        return entry

    def load(self, *inputs) -> tuple[torch.Tensor, ...]:
        """Refill the static input buffers of ``inputs``' key (made at a new
        key) and return them, without running the step: ``fn`` called on
        them is the eager step on the same inputs."""
        return self._load(inputs).inputs

    def __call__(self, *inputs):
        entry = self._load(inputs)
        if entry.graph is not None:
            entry.graph.replay()
            kernels.add_counts(entry.launches)
            return entry.outputs
        out = self.fn(*entry.inputs)
        entry.ran = True
        if self.device.type == "cuda" and self.capture:
            self._capture(entry)
        return out

    def _capture(self, entry: _Entry) -> None:
        before = kernels.read_counts()
        graph = torch.cuda.CUDAGraph()
        # graphs of dropped owners go now, not inside the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the stream context restores the caller's stream however the
            # capture ends (``torch.cuda.graph`` leaves its capture stream
            # current when ``capture_end`` raises)
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._capture_stream()):
                torch.cuda.synchronize()
                graph.capture_begin(pool=self.pool.handle)
                try:
                    outputs = self.fn(*entry.inputs)
                finally:
                    graph.capture_end()     # raises if the capture failed
        except BaseException:
            key = next(k for k, e in self._entries.items() if e is entry)
            del self._entries[key]
            self.pool.renew()
            raise
        finally:
            if collecting:
                gc.enable()
            after = kernels.read_counts()
            delta = {name: after[name] - before[name] for name in after}
            kernels.add_counts({name: -n for name, n in delta.items()})
        entry.graph, entry.outputs, entry.launches = graph, outputs, delta

    def _capture_stream(self) -> torch.cuda.Stream:
        """The side stream this step captures on (a capture may not run on
        the default stream)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream
