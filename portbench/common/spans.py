"""The program's own spans (``sdag_tpu_torch.utils.profiling``) of a
traced segment's batches, for the per-layer readers.

A span belongs to a batch when its ``batch`` is the batch's first query id
as a string: ``drivers/poison.py`` passes ``str(q0)`` first among the
batch's query ids, and the orchestrator marks every span of the batch
with it.  A program that records no spans (no ``spans()``, or none of
these batches) gives an empty list, and the readers then return None."""

from __future__ import annotations

from typing import Any, Dict, List


def segment_spans(st: Dict[str, Any]) -> List[Any]:
    """Finished spans of the batches in ``st["segment_records"]``."""
    from sdag_tpu_torch.utils import profiling
    get = getattr(profiling, "spans", None)
    if get is None:
        return []
    ids = {str(r["q0"]) for r in st.get("segment_records", [])}
    return [s for s in get()
            if s.batch in ids and s.end_ns is not None]


def ms_per_batch(st: Dict[str, Any], names) -> Any:
    """Milliseconds of the named spans summed over the segment, per batch
    of the segment; None when the segment holds none of them."""
    picked = [s for s in segment_spans(st) if s.name in names]
    if not picked:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in picked) / len(
        st["segment_records"])


def count(st: Dict[str, Any], name: str) -> int:
    """How many spans of one name the segment holds."""
    return sum(s.name == name for s in segment_spans(st))
