"""Spans, counters and traces of the port (counterpart of
``tante_tpu/utils/profiling.py``).

- ``span(name)``: a context manager around one piece of work at a layer
  boundary (``serve.rollout``, ``tante.head``, ``ops.load``, ...).  While
  nothing records, it is one shared null context after a single check of a
  module global: no allocation, no clock read;
- ``count(name, n=1)``: add ``n`` to a counter while recording;
- ``record()``: a context manager that turns recording on and yields the
  ``Record``: spans as ``Span(name, start_ns, end_ns, parent)``, counters in
  a ``Counter``; ``Record.take()`` hands over and clears what was recorded
  so far, to cut the record per unit of work;
- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace of host and device activity (CPU, and
  CUDA when a card is present) into ``logdir``; while it is open, every
  span is also a ``record_function`` of the same name in that trace;
- ``hard_sync(tree)``: wait until the devices of every tensor leaf of a
  nested structure have finished their queued work, for honest wall-clock
  timing (CUDA calls are asynchronous).

Spans are on ``time.time_ns()``, the clock on which ``torch.profiler``
places a Chrome trace (its ``baseTimeNanoseconds``), so a span can be laid
over the device's timeline.  No span or counter synchronises the card,
reads a tensor or records a device event: the device's side is the
profiler's.  Recording is turned on by ``record()`` alone.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch


class Span(NamedTuple):
    """One span: wall-clock nanoseconds (``time.time_ns``) and the index of
    the enclosing span in the same list (-1 for a root).  The spans under
    one root (a ``serve.rollout``) belong to one request: the root's index
    is its id."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int


class Record:
    """What ``record()`` holds.  The stack of open spans is per thread;
    spans and counters are shared by every thread of the process."""

    def __init__(self):
        self.counters: Counter = Counter()
        # [name, start_ns, end_ns, the parent's entry or None], closed in
        # place; list.append is atomic, so entering a span takes no lock.
        self._entries: List[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def spans(self) -> List[Span]:
        """The spans recorded since the start or the last ``take``."""
        return _spans(self._entries)

    def _enter(self, name: str) -> list:
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        entry = [name, 0, None, stack[-1] if stack else None]
        stack.append(entry)
        self._entries.append(entry)
        entry[1] = time.time_ns()
        return entry

    def _exit(self, entry: list) -> None:
        entry[2] = time.time_ns()
        self._local.stack.pop()

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += n

    def take(self) -> Tuple[List[Span], Counter]:
        """-> (spans, counters) since the start or the last ``take``, which
        are cleared; a span's ``parent`` indexes the returned list.  Call it
        between units of work: with a span open it raises RuntimeError."""
        with self._lock:
            entries, counters = self._entries, self.counters
            if any(e[2] is None for e in entries):
                raise RuntimeError("take() with a span open")
            self._entries, self.counters = [], Counter()
        return _spans(entries), counters


def _spans(entries: List[list]) -> List[Span]:
    index = {id(e): i for i, e in enumerate(entries)}
    return [Span(e[0], e[1], e[2], -1 if e[3] is None else index[id(e[3])]) for e in entries]


_NULL = contextlib.nullcontext()
_record: Optional[Record] = None
_traced = False
_on = False  # _record is not None or _traced: the one check of an idle span


class _Span:
    __slots__ = ("name", "rec", "entry", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.name) if _traced else None
        if self.fn is not None:
            self.fn.__enter__()
        self.rec = _record
        if self.rec is not None:
            self.entry = self.rec._enter(self.name)

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.entry)
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """``with span("tante.head"): ...``: a span while recording or tracing."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    rec = _record
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def record() -> Iterator[Record]:
    """Record every span and counter of the process until the block ends.
    One record at a time: a second one raises RuntimeError."""
    global _record, _on
    if _record is not None:
        raise RuntimeError("a record is open already")
    rec = _record = Record()
    _on = True
    try:
        yield rec
    finally:
        _record = None
        _on = _traced


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    global _traced, _on
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = _traced
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        _traced = _on = True
        try:
            yield prof
        finally:
            _traced = was
            _on = _traced or _record is not None


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def hard_sync(tree: Any) -> None:
    """Synchronise every CUDA device that holds a tensor leaf of ``tree``
    (dicts, lists and tuples are walked; CPU tensors need nothing)."""
    for device in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
