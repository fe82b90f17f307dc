"""Captured programs: a body captured once per key as a CUDA graph and
replayed, the port's counterpart of a program XLA compiles once per
shape and dispatches whole.

A :class:`CapturedLoop` keeps one entry a key (the key names the shapes
and the input tensors the body reads; see the hazards below). On the
card the first :meth:`CapturedLoop.run` of a key runs the body once
eagerly on a side stream (the warm-up PyTorch asks for before a capture:
lazy handles, the kernels' shared-memory attributes, a walk plan's chunk
table), captures it with ``torch.cuda.CUDAGraph`` and replays it; later
runs only replay, nothing read back to the host between replays. On the
CPU the same entry runs the body eagerly, so the CPU tests see one
preparation a key and none in steady rounds (:attr:`CapturedLoop.captures`,
:meth:`CapturedLoop.cache_size`). Its users: the depthwise and leaf-wise
``mega`` schedules (``tree/grow.py``, ``tree/lossguide.py``) and the
serving walk's per-bucket graphs (``serve/registry.py``).

The hazards of a captured body, each handled here or by its caller:

- **Launch counters.** The kernel wrappers count launches in Python
  (``ops/cuda/hist.py _count``, ``ops/cuda/walk.py``), and Python runs at
  capture only. While a thread captures, its counts go to the capture's
  tally instead (:func:`tally`); every replay adds the tally to the
  wrappers' counts, so a count is the kernels the device ran.
- **Scratch memory.** A wrapper allocates its scratch and outputs per
  launch (``ops/cuda/hist.py _tiles``); under capture they come from the
  graph's private pool and the next replay writes them again. A body
  therefore keeps its results in static buffers that the caller consumes
  or clones before the next replay (a multiclass round replays one
  graph per class tree).
- **Raw pointers.** The graph holds the device addresses of everything
  the body read (``bins.data_ptr()`` among them). A key names the input
  tensors that are not copied into static buffers (a matrix's bins by
  address, shape and type), so a second matrix of the same shape never
  replays the first one's graph.
- **No host reads in a body.** ``.item()``, ``int(t)``, ``bool(t)``,
  ``.cpu()``, ``torch.nonzero`` or a size read from the device (the CPU
  plain sort's ``int(offsets[-1])``, ``ops/histogram.py``) cannot be
  captured; the capture raises and the error goes to the caller. Nothing
  here catches it: a failed capture is never turned into an eager run.
- **Plan arguments are safe.** A kernel's plan goes in as a host array
  that ``csrc/hist.cu`` (``run_tiles``) and ``csrc/walk.cu`` read when
  the launch is made, so the captured launch holds its fields by value;
  the plan depends on the shapes alone (``ops/cuda/hist.py hist_plan``),
  and the items of a sorted build are counted on the device.

A body is captured only where every tensor it touches sits on one device
and no host communicator joins it; elsewhere (``capture=False``) the same
body runs eagerly through the same entry, under the span
``graphs/uncaptured`` (on the CPU: ``graphs/eager``; the replays run
under ``graphs/replay``, a capture under ``graphs/capture``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Optional

import torch

from ...obs import trace as _trace

_local = threading.local()


def tally(kind: str, name: str) -> bool:
    """Called by a kernel wrapper where it counts a launch: while this
    thread captures, the launch goes to the capture's tally (and True is
    returned: the wrapper leaves its counts alone)."""
    t = getattr(_local, "tally", None)
    if t is None:
        return False
    t[(kind, name)] = t.get((kind, name), 0) + 1
    return True


def _add_launches(counts: Dict[tuple, int], times: int) -> None:
    """A replay's launches, ``times`` replays of a capture's tally, into
    the wrappers' counts."""
    from . import hist, walk

    for (kind, name), k in counts.items():
        if kind == "hist":
            hist.add_launches(name, k * times)
        else:
            walk.add_launches(name, k * times)


class _Entry:
    __slots__ = ("program", "graph", "counts", "prepared")

    def __init__(self, program) -> None:
        self.program = program
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Dict[tuple, int] = {}
        self.prepared = False


class CapturedLoop:
    """Programs keyed by shape on ``device``: each a body captured once
    and replayed (module docstring). ``name`` labels its spans."""

    def __init__(self, name: str, device) -> None:
        self.name = name
        self.device = torch.device(device)
        self._entries: Dict[Hashable, _Entry] = {}
        self._lock = threading.Lock()
        # preparations made: a graph captured on the card, an entry made
        # on the CPU (never decreases; what a recompile counter reads)
        self.captures = 0
        self.replays = 0        # body iterations run by graph replays
        self.eager_runs = 0     # body iterations run eagerly

    def cache_size(self) -> int:
        """Entries held now."""
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry: its graph and the graph's memory pool."""
        with self._lock:
            self._entries.clear()

    def entry(self, key: Hashable, make: Callable[[], object]) -> _Entry:
        """The entry of ``key`` (its ``program`` made by ``make()`` on
        first use), whose buffers a caller fills before
        :meth:`run_entry`. The entry keeps its program and graph alive
        when :meth:`clear` drops it from the cache in between."""
        with self._lock:
            return self._entry(key, make)

    def _entry(self, key: Hashable, make) -> _Entry:
        ent = self._entries.get(key)
        if ent is None:
            ent = self._entries[key] = _Entry(make())
        return ent

    def run(self, key: Hashable, make: Callable[[], object], n: int,
            load: Optional[Callable[[object], None]] = None, *,
            capture: bool = True):
        """The program of ``key`` (``make()`` on first use: an object
        whose ``body()`` is one iteration over static buffers), with
        ``load(program)`` first (inputs into its buffers, its state
        reset), then ``n`` iterations: replays of its graph on the card,
        eager calls on the CPU or where ``capture`` is False. Returns the
        program, whose buffers hold the results until the next run."""
        with self._lock:
            return self._run(self._entry(key, make), n, load, capture)

    def run_entry(self, ent: _Entry, n: int,
                  load: Optional[Callable[[object], None]] = None, *,
                  capture: bool = True):
        """:meth:`run` of an entry from :meth:`entry`."""
        with self._lock:
            return self._run(ent, n, load, capture)

    def _run(self, ent: _Entry, n: int, load, capture: bool):
        """One run of ``ent`` (the lock held)."""
        prog = ent.program
        if load is not None:
            load(prog)
        if self.device.type != "cuda" or not capture:
            if not ent.prepared:
                ent.prepared = True
                self.captures += 1
            with _trace.span("graphs/eager" if capture
                             else "graphs/uncaptured",
                             args={"loop": self.name, "n": n}):
                for _ in range(n):
                    prog.body()
            self.eager_runs += n
            return prog
        if ent.graph is None:
            ent.graph, ent.counts = self._capture(prog)
            ent.prepared = True
            self.captures += 1
            if load is not None:
                load(prog)          # the warm-up ran the body once
        with _trace.span("graphs/replay",
                         args={"loop": self.name, "n": n}):
            for _ in range(n):
                ent.graph.replay()
        _add_launches(ent.counts, n)
        self.replays += n
        return prog

    def _capture(self, prog):
        """Warm ``prog.body`` up once on a side stream, then capture it.
        Raises whatever the capture raises."""
        with torch.cuda.device(self.device), \
                _trace.span("graphs/capture", args={"loop": self.name}):
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                prog.body()
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            _local.tally = {}
            try:
                # thread_local: another thread's calls (a server replica's
                # copies) stay legal while this one captures
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    prog.body()
            finally:
                counts, _local.tally = _local.tally, None
        return graph, counts
