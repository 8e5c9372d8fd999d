"""The port's span recorder, the fit's phase timer as a view of it, and
the fit's profiler trace (``trace``), ported from
``bigkrls_tpu/utils/progress.py``.

A span is one piece of a public call (``fit``, ``predict``): its name,
its parent, the id of the call (the root span's id, shared by every span
of the call), its host interval on ``time.perf_counter`` and its counters
(``host_reads``: the calls that make the host wait on the device, counted
at the port's read points whatever the device: reads to the host, and
copies from pageable host memory to the device, which wait for the
stream too; ``bytes_to_host``, ``bytes_to_device``: ``predict``'s
copies; ``bytes_between_cards``: the bytes a mesh copies from one card to
another, ``parallel/sharded.py``). On CUDA cards every span under a
call's root also holds its interval on the device clock, between CUDA
events (from a per-process pool of each card) recorded on the call's
stream, one where the root opens and one where each span closes
(:class:`Recorder`), read once the call has ended: the call has waited
for its results on the host by then, so the read adds no synchronize. A
call on several cards (a mesh) keeps one such line of events on each
card's current stream, and a span holds its interval on each card
(``device_s_by_card``), its ``device_s`` the longest of them: the card
that sets the pace. The root itself and the CPU have the host interval
alone. Finished calls go into one bounded log in memory (:func:`spans`);
nothing is written to disk.

The recorder is always on and cheap: no synchronize, no logging, no
device allocation. While the program's own :func:`trace` runs, each span
also opens a ``torch.profiler.record_function`` range named
``bigkrls.<path>`` (``bigkrls.fit/eigendecomposition/krylov``); outside
it, none, so another profiler (a benchmark's) sees no program ranges.

``PhaseTimer`` gives ``model.timings``: on one card each phase is the
device interval between two marks, with no synchronize; on a mesh of
several cards ``mark`` synchronizes each of them, as PyTorch returns from
a CUDA call before the card has run it, and the phase is the host
interval between marks.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

# finished spans the log keeps, the oldest dropped first: a 30 s window of
# about 5,000 predict requests of 5 spans each, and room to spare
LOG_SIZE = 1 << 16

_INHERIT = object()

# the fit's phases (``model.timings``), in order
PHASES = ("kernel", "eigendecomposition", "lambda_search", "coefficients",
          "derivatives")


class Span:
    """One timed piece of a call. ``path`` is its name under its
    parents' (``"fit/eigendecomposition/krylov"``); ``parent`` and
    ``call`` are span ids; ``t0``, ``t1`` the host interval;
    ``device_s`` the device interval in seconds (None where there is
    none); ``device_s_by_card`` the interval on each card of a call on
    several, in the call's card order (None on one card), ``device_s``
    their largest; ``counters`` what was counted while it was the
    innermost open span."""

    __slots__ = ("name", "path", "id", "parent", "call", "t0", "t1",
                 "device_s", "device_s_by_card", "counters", "_root",
                 "_members", "_stream", "_free", "_e0", "_e1", "_last",
                 "_marked", "_range")

    @property
    def host_s(self) -> float:
        return self.t1 - self.t0

    @property
    def seconds(self) -> float:
        """The device interval where there is one, else the host's."""
        return self.host_s if self.device_s is None else self.device_s

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def __repr__(self):
        return (f"Span({self.path!r}, call={self.call}, "
                f"seconds={self.seconds:.6f}, counters={self.counters})")


class Record(NamedTuple):
    """A finished span as :func:`spans` returns it (the fields of
    :class:`Span`)."""
    name: str
    path: str
    id: int
    parent: Optional[int]
    call: int
    t0: float
    t1: float
    device_s: Optional[float]
    counters: Dict[str, int]
    device_s_by_card: Optional[Tuple[float, ...]] = None

    @property
    def host_s(self) -> float:
        return self.t1 - self.t0

    @property
    def seconds(self) -> float:
        """The device interval where there is one, else the host's."""
        return self.host_s if self.device_s is None else self.device_s


def cards(devices) -> Optional[Tuple[torch.device, ...]]:
    """The distinct CUDA devices among ``devices``, in order (virtual
    shards that repeat one card are that card), or None where there is
    none: the cards a call's spans are timed on."""
    cuda = tuple(dict.fromkeys(torch.device(d) for d in devices
                               if torch.device(d).type == "cuda"))
    return cuda or None


class Recorder:
    """The process's spans: the open ones per thread, finished calls whose
    device intervals are not read yet, and the bounded log.

    A timed call is a line of CUDA events on its stream: one where its
    root opens, one where each span under it closes. A span's device
    interval runs from the call's latest event when it opens (its
    parent's start or the previous span's end) to its own: spans are laid
    back to back, and device work enqueued between two of them counts in
    the later one. A span opened with ``mark`` records one more event
    where it opens, so that its interval holds its own work alone, not
    what its parent enqueued before it. A call on several cards keeps one
    line on each card's stream, recorded at the same points: its events
    are tuples, one event of each card's pool a card."""

    def __init__(self, size: int = LOG_SIZE):
        # finished spans as tuples of numbers and strings, which the
        # garbage collector stops tracking: a log of tracked objects made
        # every collection walk it (three times the cost of a span)
        self.log = collections.deque(maxlen=size)
        self.profiling = 0       # depth of the program's own trace()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending = collections.deque()   # finished calls' spans
        self._pool = collections.defaultdict(list)  # card -> free events

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    @staticmethod
    def _record(root: Span):
        """A free event of the call's card, recorded on its stream; on
        several cards a tuple of one such event a card."""
        if isinstance(root._stream, tuple):
            return tuple(Recorder._record_on(stream, pool)
                         for stream, pool in zip(root._stream, root._free))
        return Recorder._record_on(root._stream, root._free)

    @staticmethod
    def _record_on(stream, pool):
        try:
            e = pool.pop()
        except IndexError:
            e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def open(self, name: str, device=_INHERIT, mark: bool = False) -> Span:
        """Open a span under the innermost open one, or as the root of a
        new call. For a root, ``device`` is the CUDA device on whose
        current stream the call's spans are timed, a tuple of the CUDA
        devices of a call on several (:func:`cards`), or None for host
        intervals alone; a span under it is timed as its call is, or not
        at all with ``device=None``. Without an open span and without
        ``device`` (a step called outside ``fit`` and ``predict``) the
        span is inert: nothing is recorded. ``mark``: a timed span under a
        root starts at an event recorded where it opens."""
        stack = self._stack()
        s = Span()
        s.name, s.counters, s.device_s, s._range = name, {}, None, None
        s._e0 = s._e1 = s.device_s_by_card = None
        s._marked = False
        if stack:
            up = stack[-1]
            s.id, s.parent, s.call = next(self._ids), up.id, up.call
            s.path, s._members, s._root = (up.path + "/" + name,
                                           up._members, up._root)
            if device is not None:
                s._e0 = s._root._last      # None in an untimed call
                if mark and s._e0 is not None:
                    s._e0 = s._root._last = self._record(s._root)
                    s._marked = True
        elif device is _INHERIT:
            s.path, s.call = name, None
            return s
        else:
            s.id = s.call = next(self._ids)
            s.parent, s.path, s._members, s._root = None, name, [], s
            s._stream = s._last = None
            if isinstance(device, tuple) and len(device) == 1:
                device = device[0]
            if isinstance(device, tuple):
                if torch.cuda.is_available():
                    s._stream = tuple(torch.cuda.current_stream(d)
                                      for d in device)
                    s._free = tuple(self._pool[st.device_index]
                                    for st in s._stream)
                    s._e0 = s._last = self._record(s)
            elif device is not None and torch.device(device).type == "cuda" \
                    and torch.cuda.is_available():
                s._stream = torch.cuda.current_stream(device)
                s._free = self._pool[s._stream.device_index]
                # the call's first event (the root holds no interval)
                s._e0 = s._last = self._record(s)
        if self.profiling:
            s._range = torch.profiler.record_function("bigkrls." + s.path)
            s._range.__enter__()
        stack.append(s)
        s.t0 = time.perf_counter()
        return s

    def close(self, s: Span) -> None:
        """Close ``s``; spans opened inside it and left open (by an
        exception) are dropped. Closing a call's root hands its spans to
        the log once their device intervals can be read."""
        if s.call is None:
            return
        s.t1 = time.perf_counter()
        if s._e0 is not None and s.parent is not None:
            s._e1 = s._root._last = self._record(s._root)
        stack = self._stack()
        while stack and stack[-1] is not s:
            self._exit_range(stack.pop())
        if stack:
            stack.pop()
        if s._range is not None:
            self._exit_range(s)
        s._members.append(s)
        if s.parent is None:
            self._pending.append(s._members)
            self.drain(wait=False)

    @staticmethod
    def _exit_range(s: Span) -> None:
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None

    @staticmethod
    def settle(s: Span) -> None:
        """Read ``s``'s device interval now: its end has passed on the
        device (the caller has read a result made after it); on several
        cards its interval on each, ``device_s`` the longest."""
        if s._e1 is not None and s.device_s is None:
            if isinstance(s._e1, tuple):
                s.device_s_by_card = tuple(
                    a.elapsed_time(b) / 1e3 for a, b in zip(s._e0, s._e1))
                s.device_s = max(s.device_s_by_card)
            else:
                s.device_s = s._e0.elapsed_time(s._e1) / 1e3

    @staticmethod
    def _passed(last) -> bool:
        if isinstance(last, tuple):
            return all(e.query() for e in last)
        return last.query()

    @staticmethod
    def _release(pool, e) -> None:
        if isinstance(e, tuple):
            for p, ev in zip(pool, e):
                p.append(ev)
        else:
            pool.append(e)

    def drain(self, wait: bool) -> None:
        """Move finished calls, oldest first, into the log, each once its
        last event has passed on the device; with ``wait``, waiting for
        the device where it has not yet."""
        with self._lock:
            while self._pending:
                members = self._pending[0]
                root = members[-1]
                last = root._last
                if last is not None and not self._passed(last):
                    if not wait:
                        return
                    for e in (last if isinstance(last, tuple) else (last,)):
                        e.synchronize()
                self._pending.popleft()
                if last is not None:
                    pool = root._free
                    self._release(pool, root._e0)
                    for s in members:
                        if s._e1 is not None:
                            self.settle(s)
                            self._release(pool, s._e1)
                        if s._marked:
                            self._release(pool, s._e0)
                for s in members:
                    s._root = s._members = s._stream = s._free = None
                    s._e0 = s._e1 = s._last = None
                self.log.extend((s.name, s.path, s.id, s.parent, s.call,
                                 s.t0, s.t1, s.device_s,
                                 tuple(s.counters.items()),
                                 s.device_s_by_card)
                                for s in members)

    def spans(self) -> List[Record]:
        """Every finished span in the log (see :func:`spans`)."""
        self.drain(wait=True)
        return [Record(*t[:8], dict(t[8]), t[9]) for t in self.log]

    def count(self, key: str, n: int = 1) -> None:
        stack = self._stack()
        if stack:
            stack[-1].count(key, n)


RECORDER = Recorder()


class span:
    """``with span("krylov") as s:`` records a span under the innermost
    open one (see :meth:`Recorder.open` for ``device`` and ``mark``)."""

    __slots__ = ("_name", "_device", "_mark", "_span")

    def __init__(self, name: str, device=_INHERIT, mark: bool = False):
        self._name, self._device, self._mark = name, device, mark

    def __enter__(self) -> Span:
        self._span = RECORDER.open(self._name, self._device, self._mark)
        return self._span

    def __exit__(self, *exc) -> None:
        RECORDER.close(self._span)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the innermost open span (nothing
    without one)."""
    RECORDER.count(key, n)


def spans() -> List[Record]:
    """Every finished span in the log, oldest call first (each call's
    spans in the order they closed, its root last). Reads the device
    intervals still outstanding, waiting for the device if need be."""
    return RECORDER.spans()


class PhaseTimer:
    """The fit's phases (``model.timings``). ``device`` is the fit's
    device, or the devices of its mesh (they may repeat: virtual shards).
    Inside a call each phase is a span under it, named from ``PHASES``
    from the start (so is its profiler range); ``mark(name)`` ends the
    open phase as ``name`` and opens the next. Outside a call, and past
    the five phases, a phase is the host interval between marks."""

    def __init__(self, device: Union[None, torch.device, str,
                                     Sequence] = None):
        if device is None:
            device = []
        elif isinstance(device, (torch.device, str)):
            device = [device]
        cuda = [torch.device(d) for d in device
                if torch.device(d).type == "cuda"]
        self.devices = list(dict.fromkeys(cuda))
        self.phases: List[Dict] = []
        self._spans: List[Optional[Span]] = []
        self._last = time.perf_counter()
        self._open = self._begin()

    def _begin(self) -> Optional[Span]:
        i = len(self._spans)
        if i >= len(PHASES) or not RECORDER._stack():
            return None
        return RECORDER.open(PHASES[i])

    def mark(self, name: str) -> None:
        """Record the time since the previous mark (or construction) as
        one phase. On several cards each is synchronized first."""
        if len(self.devices) > 1:
            for d in self.devices:
                torch.cuda.synchronize(d)
        s = self._open
        if s is not None:
            if s.name != name:
                s.path = s.path[:len(s.path) - len(s.name)] + name
                s.name = name
            RECORDER.close(s)
            now = s.t1
        else:
            now = time.perf_counter()
        self._spans.append(s)
        self.phases.append({"phase": name,
                            "seconds": round(now - self._last, 4)})
        self._last = now
        self._open = self._begin()

    def finish(self) -> List[Dict]:
        """The phases; on one card with device intervals, read now (the
        fit has read results made after its last mark). On several cards
        the host intervals between the synchronized marks."""
        if len(self.devices) > 1:
            return self.phases
        timed = [s for s in self._spans if s is not None and s._e1 is not None]
        if timed and not timed[-1]._e1.query():
            timed[-1]._e1.synchronize()
        for entry, s in zip(self.phases, self._spans):
            if s is not None:
                RECORDER.settle(s)
                entry["seconds"] = round(s.seconds, 4)
        return self.phases


@contextlib.contextmanager
def trace(logdir: Optional[str], device=None):
    """Run the region under ``torch.profiler`` and write a TensorBoard /
    Chrome trace (``*.pt.trace.json``) into ``logdir``: host activity,
    plus the device's kernels when ``device`` is a CUDA device, and the
    program's spans as ranges (``bigkrls.<path>``). The counterpart of
    the JAX package's ``xla_trace``; no-op without ``logdir``."""
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        RECORDER.profiling += 1
        try:
            yield
        finally:
            RECORDER.profiling -= 1
