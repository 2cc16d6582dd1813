"""Result writers: per-query CSV rows + per-pair metrics JSON.

Column set and joins match the reference writer
(``src/pipeline/utils/save_results.py:42-93``): 13 fixed columns, documents
joined by ``" ||| "``, and an ACC/ASR console summary for ISO and NO-ISO.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List

RESULT_FIELDS = [
    "query_id",
    "question",
    "short_answers",
    "false_answer",
    "malicious_doc",
    "retrieved_docs",
    "retrieved_doc_ids",
    "rag_answer_iso",
    "rag_answer_noiso",
    "ground_truth_match_iso",
    "ground_truth_match_noiso",
    "false_match_iso",
    "false_match_noiso",
]

DOC_JOIN = " ||| "


def save_results(results: List[Dict[str, Any]], csv_path: str) -> Dict[str, float]:
    """Write per-query rows to CSV and print the ACC/ASR summary.

    Returns the summary dict {acc_iso, acc_noiso, asr_iso, asr_noiso}.
    """
    out_dir = os.path.dirname(csv_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    with open(csv_path, "w", encoding="utf-8", newline="") as fout:
        writer = csv.DictWriter(fout, fieldnames=RESULT_FIELDS)
        writer.writeheader()
        for r in results:
            fa = r.get("false_answer", "")
            writer.writerow({
                "query_id": r.get("query_id", ""),
                "question": r["question"],
                "short_answers": "\n".join(r["short_answers"]),
                "false_answer": "\n".join(fa) if isinstance(fa, list) else fa,
                "malicious_doc": r.get("malicious_doc", ""),
                "retrieved_docs": DOC_JOIN.join(r["retrieved_docs"]),
                "retrieved_doc_ids": "\n".join(r["retrieved_doc_ids"]),
                "rag_answer_iso": r["rag_answer_iso"],
                "rag_answer_noiso": r["rag_answer_noiso"],
                "ground_truth_match_iso": int(r["ground_truth_match_iso"]),
                "ground_truth_match_noiso": int(r["ground_truth_match_noiso"]),
                "false_match_iso": int(r["false_match_iso"]),
                "false_match_noiso": int(r["false_match_noiso"]),
            })

    total = len(results)
    gt_iso = sum(1 for r in results if r["ground_truth_match_iso"])
    gt_noiso = sum(1 for r in results if r["ground_truth_match_noiso"])
    asr_iso = sum(1 for r in results if r["false_match_iso"])
    asr_noiso = sum(1 for r in results if r["false_match_noiso"])

    print(f"Total queries: {total}")
    if total:
        print(f"[ISO]    true answer rate: {gt_iso}/{total} = {gt_iso/total:.3f}")
        print(f"[NO-ISO] true answer rate: {gt_noiso}/{total} = {gt_noiso/total:.3f}")
        print(f"[ISO]    attack success rate: {asr_iso}/{total} = {asr_iso/total:.3f}")
        print(f"[NO-ISO] attack success rate: {asr_noiso}/{total} = {asr_noiso/total:.3f}")

    return {
        "acc_iso": gt_iso / total if total else 0.0,
        "acc_noiso": gt_noiso / total if total else 0.0,
        "asr_iso": asr_iso / total if total else 0.0,
        "asr_noiso": asr_noiso / total if total else 0.0,
    }


def save_metrics_json(metrics: Dict[str, Any], json_path: str) -> None:
    out_dir = os.path.dirname(json_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(metrics, f, indent=2, ensure_ascii=False)
