"""Device trace of a traced segment: busy time as the union of the device's
operation intervals, device time by operation name, and the idle gaps
named by what the host was doing.

After ``chip_smoke.py``'s ``_profile_window`` and ``_device_rows``
(torch.profiler over CPU and CUDA; device rows are the CUDA events), with
the busy share taken from the union of kernel intervals, not their sum, so
that overlapping streams cannot read over 100%.  Spans are the harness's
own ``record_function`` ranges around its calls into the program.
"""

from __future__ import annotations

import bisect
import collections
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


class Segment:
    """What one traced segment measured."""

    def __init__(self) -> None:
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernel_s: Dict[str, float] = collections.Counter()
        self.kernel_n: Dict[str, int] = collections.Counter()
        self.gaps: Dict[str, float] = collections.Counter()
        self.device_events = 0

    def device_seconds(self, substr: str) -> Optional[float]:
        """Device seconds of the operations whose name holds ``substr``,
        None when none ran."""
        s = sum(v for k, v in self.kernel_s.items() if substr in k)
        n = sum(v for k, v in self.kernel_n.items() if substr in k)
        return s if n else None

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List]:
    intervals.sort()
    busy, merged = 0, []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for a, b in merged:
        busy += b - a
    return busy, merged


@contextmanager
def traced(device):
    """Profile the body (CPU + CUDA); yields the Segment, filled on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    seg = Segment()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield seg
        torch.cuda.synchronize(device)
        seg.window_s = time.perf_counter() - t0
    _read(prof, seg)


def _is_device_op(e) -> bool:
    """A kernel, copy or memset: not the device-timeline copy of a host
    ``record_function`` range, which spans whatever ran inside it (the
    harness names its ranges ``pb.*``)."""
    if e.is_user_annotation() or e.name().startswith("pb."):
        return False
    kind = getattr(e, "activity_type", None)
    return kind is None or "annotation" not in str(kind()).lower()


def _read(prof, seg: Segment) -> None:
    from torch.autograd import DeviceType
    dev_iv: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA and _is_device_op(e):
            if b > a:
                dev_iv.append((a, b))
                seg.kernel_s[e.name()] += (b - a) * 1e-9
                seg.kernel_n[e.name()] += 1
        elif e.device_type() != DeviceType.CUDA and b > a:
            host.append((a, b, e.name()))
    seg.device_events = len(dev_iv)
    if not dev_iv:
        return
    busy, merged = _union(dev_iv)
    seg.busy_s = busy * 1e-9
    # each gap of 50 us or more is named by the shortest host range (the
    # innermost) that covers its midpoint; shorter ones are summed apart
    host.sort()
    starts = [h[0] for h in host]
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gap = nxt - end
        if gap < 50_000:
            seg.gaps["gaps under 50 us"] += gap * 1e-9
            continue
        mid = (end + nxt) // 2
        best = None
        i = bisect.bisect_right(starts, mid)
        for a, b, name in host[max(0, i - 2000):i]:
            if a <= mid < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        seg.gaps[best[2] if best else "no host range"] += gap * 1e-9
