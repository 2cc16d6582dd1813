"""Phase timing + optional torch.profiler traces.

Every pipeline phase is timed; setting ``SDAG_TPU_PROFILE_DIR`` captures a
torch.profiler trace (CPU + CUDA activities) of the wrapped region as a
Chrome trace in that directory, viewable in Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class PhaseTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
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
    set."""
    trace_dir = os.environ.get("SDAG_TPU_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"trace_{os.getpid()}.json"))
