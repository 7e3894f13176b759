"""The port's tracer: named spans on the ``time.perf_counter`` clock.

    from multiposenet_tpu_torch.utils import trace

    with trace.span("train.step", state.step):
        with trace.span("train.forward"):
            ...

Every span adds its calls and seconds to per-name totals, which the
Trainer's log line reads (``totals()``).  Between ``enable()`` and
``disable()``, the one switch of the timeline, every span also leaves one
row in memory, which ``drain()`` hands out:

- ``id``: what the caller passed (the step number, in the train steps),
  else the id of the span open on the same thread, so that the spans of
  one step share it;
- ``parent``: the index, in the drained rows, of the span that was open on
  the same thread when this one opened (None at a thread's top);
- ``thread``: ``threading.get_ident()`` of the thread that ran it;
- ``start``, ``end``: ``time.perf_counter()`` seconds, the host clock a
  device trace's events are mapped onto; ``end`` is None for a span still
  open when the rows were drained.

The rows stay in memory until ``drain()``.  Spans are safe on any thread:
each keeps its own stack of open spans and its own totals.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple


class Row(NamedTuple):
    name: str
    id: Optional[int]
    parent: Optional[int]
    thread: int
    start: float
    end: Optional[float]


_clock = time.perf_counter
_lock = threading.Lock()
_enabled = False
_rows: List[list] = []                       # [name, id, parent, thread, start, end]
_thread_totals: List[Dict[str, list]] = []   # one {name: [calls, seconds]} a thread


class _Thread(threading.local):
    def __init__(self):
        self.ident = threading.get_ident()
        self.stack: List[_Span] = []         # the spans open on this thread
        self.totals: Dict[str, list] = {}
        with _lock:
            _thread_totals.append(self.totals)


_local = _Thread()


class _Span:
    """One span: its row, if the timeline is on, is ``rows[index]``."""

    __slots__ = ("name", "id", "start", "rows", "index")

    def __init__(self, name: str, id_: Optional[int]):
        self.name = name
        self.id = id_

    def __enter__(self):
        stack = _local.stack
        if self.id is None and stack:
            self.id = stack[-1].id
        self.rows = None
        self.start = _clock()
        if _enabled:
            with _lock:
                # a parent whose row was drained is no row of this list
                up = stack[-1] if stack else None
                parent = up.index if up is not None and up.rows is _rows else None
                self.rows, self.index = _rows, len(_rows)
                _rows.append([self.name, self.id, parent, _local.ident, self.start, None])
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = _clock()
        local = _local
        local.stack.pop()
        if self.rows is not None:
            self.rows[self.index][5] = end
        tot = local.totals.get(self.name)
        if tot is None:
            tot = local.totals[self.name] = [0, 0.0]
        tot[0] += 1
        tot[1] += end - self.start
        return False


def span(name: str, id: Optional[int] = None) -> _Span:  # noqa: A002
    """A context manager timing ``name``; ``id`` groups the spans of one
    unit of work (a step)."""
    return _Span(name, id)


def enable() -> None:
    """Keep a row of every span from now on."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Keep no more rows; those kept stay until ``drain()``."""
    global _enabled
    _enabled = False


def drain() -> List[Row]:
    """The rows kept so far, in the order the spans opened; forgets them."""
    global _rows
    with _lock:
        rows, _rows = _rows, []
    return [Row(*r) for r in rows]


def totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, seconds)}`` of every span closed so far, over all
    threads."""
    with _lock:
        per_thread = [dict(t) for t in _thread_totals]
    out: Dict[str, Tuple[int, float]] = {}
    for t in per_thread:
        for name, (calls, seconds) in t.items():
            c, s = out.get(name, (0, 0.0))
            out[name] = (c + calls, s + seconds)
    return out
