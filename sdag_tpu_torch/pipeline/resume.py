"""Resumable per-batch result logs.

The reference's only resume affordances are the sampled-query JSON caches
and the discern label cache (SURVEY.md §5); a crashed experiment loses all
generated answers.  Here every completed query batch is appended to a JSONL
log per (top_k, attacker_pos) pair, and a rerun with the same config skips
completed batches and reuses their rows.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Set


class BatchResultLog:
    """Append-only JSONL: row lines ``{"batch": i, "row": {...}}`` and
    completion markers ``{"batch": i, "done": true, "n": <rows>}``.  Rows
    of batches without a done marker (crash mid-batch) are discarded on
    load; a crash *inside* append_batch can also leave orphan row lines
    that a later rerun re-appends in full, so the marker records the row
    count and only the LAST n rows before it count (otherwise a resumed
    run would merge orphans with the re-appended rows and double-count
    that batch's ACC/ASR rows)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._rows_by_batch: Dict[int, List[Dict[str, Any]]] = {}
        self._done: Set[int] = set()
        self._n_rows: Dict[int, int] = {}
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except Exception:
                        continue
                    b = int(obj.get("batch", -1))
                    if obj.get("done"):
                        self._done.add(b)
                        if "n" in obj:  # absent in pre-fix logs: keep all
                            self._n_rows[b] = int(obj["n"])
                    elif "row" in obj:
                        self._rows_by_batch.setdefault(b, []).append(
                            obj["row"])
            for b, n in self._n_rows.items():
                rows = self._rows_by_batch.get(b, [])
                if len(rows) > n:  # orphans from a crashed earlier attempt
                    self._rows_by_batch[b] = rows[-n:]
            if self._done:
                print(f"[resume] {path}: {len(self._done)} completed "
                      "batches found")
        out_dir = os.path.dirname(path)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def is_done(self, batch_idx: int) -> bool:
        return batch_idx in self._done

    def rows_for(self, batch_idx: int) -> List[Dict[str, Any]]:
        if batch_idx not in self._done:
            return []
        return list(self._rows_by_batch.get(batch_idx, []))

    def append_batch(self, batch_idx: int,
                     rows: List[Dict[str, Any]]) -> None:
        with open(self.path, "a", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps({"batch": batch_idx, "row": r},
                                   ensure_ascii=False) + "\n")
            f.write(json.dumps({"batch": batch_idx, "done": True,
                                "n": len(rows)}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._rows_by_batch[batch_idx] = list(rows)
        self._done.add(batch_idx)
