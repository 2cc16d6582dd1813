"""Spans at the program's layer boundaries, phase timing, and optional
torch.profiler traces.

What an operator reads:

- ``phase_timings`` in each pair's results JSON and the ``[timing]`` lines
  ``run_experiment`` prints at its end: the totals of ``PhaseTimer``.
- With ``SDAG_TPU_PROFILE_DIR`` set, ``maybe_profile`` captures a
  torch.profiler trace (CPU + CUDA activities) of the experiment's batches
  as a Chrome trace in that directory, viewable in Perfetto.  The trace
  carries the program's spans as host ranges named ``sdag.*``.

A span (``span``) exists only while a torch.profiler collects, in that
trace or in a benchmark's traced segment; otherwise opening one costs one
check of the profiler's flag and records nothing.  While one collects, a
span enters a ``record_function`` range of its name, stamps its start and
end with ``time.time_ns()`` (the clock of the profiler's events), and
keeps a record in memory (``spans()``, ``clear_spans()``): its name,
stamps and batch (set by ``batch_context``).  Nothing here writes to disk
but ``maybe_profile``'s trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# records kept at most; spans past it still open their profiler ranges
MAX_SPANS = 200_000

_SPANS: List["SpanRecord"] = []
_BATCH: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "sdag_batch", default=None)
_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span: ``batch`` is the id of the ``batch_context`` around it
    (None outside one); ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    batch: Optional[str]
    end_ns: Optional[int] = None


@contextlib.contextmanager
def _recorded(name: str):
    rec = SpanRecord(name, time.time_ns(), _BATCH.get())
    if len(_SPANS) < MAX_SPANS:
        _SPANS.append(rec)
    elif len(_SPANS) == MAX_SPANS:
        warnings.warn(f"{MAX_SPANS} spans kept: later ones are not "
                      "recorded until clear_spans()")
    try:
        with torch.profiler.record_function(name):
            yield rec
    finally:
        rec.end_ns = time.time_ns()


def span(name: str):
    """Context manager around one layer boundary's work, named
    ``sdag.<layer>.<what>``: a recorded span while a torch.profiler
    collects (it yields the ``SpanRecord``), nothing otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _recorded(name)


@contextlib.contextmanager
def batch_context(batch_id):
    """Spans opened inside carry ``str(batch_id)`` as their batch (the
    batch's first query id); the enclosing batch is restored on exit."""
    token = _BATCH.set(None if batch_id is None else str(batch_id))
    try:
        yield
    finally:
        _BATCH.reset(token)


def spans() -> List[SpanRecord]:
    """The spans recorded since the last ``clear_spans()``, in the order
    they opened."""
    return _SPANS


def clear_spans() -> None:
    _SPANS.clear()


class PhaseTimer:
    """Host-clock totals of named phases, each phase a span
    ``sdag.orch.<name>`` on the same clock (``time.time_ns``).

    A phase is timed without a device synchronisation of its own, and
    needs none: each phase ``run_experiment`` times per batch (retrieve,
    attack_content, select_malicious, defense, generate_iso,
    generate_noiso) ends in a host read of its device results
    (retrieval's ``.cpu()`` of the hits, the encoder's embeddings, the
    Generator's ``.cpu().numpy()`` of the tokens, which wait for the
    device) or does host work only, so its total is the work's time and
    not the time to enqueue it."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time_ns()
        try:
            with span("sdag.orch." + name):
                yield
        finally:
            self.totals[name] += (time.time_ns() - t0) * 1e-9
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / self.counts[name]}
                for name in self.totals}

    def report(self) -> None:
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            print(f"[timing] {name}: {s['total_s']:.3f}s "
                  f"({s['count']}x, mean {s['mean_s']*1e3:.1f}ms)")


@contextlib.contextmanager
def maybe_profile():
    """Wrap a region in a torch.profiler trace when SDAG_TPU_PROFILE_DIR is
    set (the program's spans are recorded inside it)."""
    trace_dir = os.environ.get("SDAG_TPU_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_{os.getpid()}.json"))
