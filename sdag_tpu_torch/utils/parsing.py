"""Dataset ingest: attack-CSV loading with grouped rows.

Behavioral parity with ``src/pipeline/utils/parsing.py:9-97``: the list-field
parser tries JSON, then Python-literal, then ``|||`` split, then comma split;
rows are grouped by query, false answers deduplicated, malicious docs
accumulated per group.
"""

from __future__ import annotations

import ast
import csv
import json
from typing import List

from sdag_tpu_torch.datamodels import QueryData

REQUIRED_COLUMNS = {
    "query", "query_id", "ground_truth_answers", "false_answer",
    "malicious_document",
}


def parse_list_field(x: str) -> List[str]:
    """Parse a list from a CSV cell with the reference's fallback chain."""
    if x is None:
        return []
    x = x.strip()
    if not x:
        return []
    try:
        val = json.loads(x)
        if isinstance(val, list):
            return [str(v) for v in val]
    except Exception:
        pass
    try:
        val = ast.literal_eval(x)
        if isinstance(val, list):
            return [str(v) for v in val]
    except Exception:
        pass
    if "|||" in x:
        return [t.strip() for t in x.split("|||") if t.strip()]
    if "," in x:
        return [t.strip() for t in x.split(",") if t.strip()]
    return [x]


def load_from_csv(csv_path: str, match_field_for_groups: str = "query") -> QueryData:
    """Load an attack CSV (multiple rows per query -> multiple malicious docs
    and deduplicated false answers per query)."""
    with open(csv_path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        missing = REQUIRED_COLUMNS - set(reader.fieldnames or [])
        if missing:
            raise ValueError(f"CSV missing required columns: {missing}")

        grouped = {}
        order: List[str] = []
        for row in reader:
            key = row[match_field_for_groups]
            if key not in grouped:
                grouped[key] = {
                    "query_id": str(row["query_id"]).strip(),
                    "query": (row["query"] or "").strip(),
                    "ground_truth_answers": parse_list_field(row["ground_truth_answers"]),
                    "false_answers": [],
                    "malicious_docs": [],
                }
                order.append(key)

            false_ans = (row.get("false_answer") or "").strip()
            if false_ans and false_ans not in grouped[key]["false_answers"]:
                grouped[key]["false_answers"].append(false_ans)

            mal_doc = (row.get("malicious_document") or "").strip()
            if mal_doc:
                grouped[key]["malicious_docs"].append(mal_doc)

    data = [grouped[k] for k in order]
    return QueryData(
        query_ids=[d["query_id"] for d in data],
        questions=[d["query"] for d in data],
        short_answers=[d["ground_truth_answers"] for d in data],
        false_answer_groups=[d["false_answers"] for d in data],
        malicious_doc_groups=[d["malicious_docs"] for d in data],
    )


def load_sampled_queries_json(path: str) -> QueryData:
    """Load a sampled-queries JSON (list of {id, question, short_answers}),
    the format shipped in the reference's ``data/sampled_*_1000_queries.json``."""
    with open(path, "r", encoding="utf-8") as f:
        rows = json.load(f)
    return QueryData(
        query_ids=[str(r["id"]) for r in rows],
        questions=[str(r["question"]) for r in rows],
        short_answers=[[str(a) for a in r.get("short_answers", [])] for r in rows],
        false_answer_groups=None,
        malicious_doc_groups=None,
    )
