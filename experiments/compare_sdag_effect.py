"""Row-by-row comparison of two SDAG-effect results dirs.

Both dirs have the layout ``run_sdag_effect.py`` and
``run_sdag_effect_torch.py`` write (``nmal*/results_top_k=*_attacker_pos=*
.csv``, plain or gzipped).  For every cell of RUN_DIR, the cell of the same
name in REF_DIR must hold the same queries in the same order; a row differs
when any of the answers or match flags differs.

Usage::

    python experiments/compare_sdag_effect.py REF_DIR RUN_DIR

Prints one line per cell (rows, differing rows) and each differing row;
exits 1 when a cell of RUN_DIR is missing from REF_DIR or RUN_DIR holds
no cell.
"""

from __future__ import annotations

import argparse
import csv
import glob
import gzip
import io
import json
import os
import sys
from typing import Dict, List

COLUMNS = ("rag_answer_iso", "rag_answer_noiso", "ground_truth_match_iso",
           "ground_truth_match_noiso", "false_match_iso",
           "false_match_noiso")


def read_rows(path: str) -> List[Dict[str, str]]:
    """A results CSV, from ``path`` or ``path + '.gz'``."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path += ".gz"
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            text = fh.read().decode("utf-8")
    else:
        with open(path, encoding="utf-8", newline="") as fh:
            text = fh.read()
    return list(csv.DictReader(io.StringIO(text, newline="")))


def cells(root: str) -> List[str]:
    """Cell names (``nmal1/results_top_k=5_attacker_pos=1.csv``)."""
    found = set()
    for path in glob.glob(os.path.join(root, "nmal*", "results_*pos=*.csv*")):
        rel = os.path.relpath(path, root)
        found.add(rel[:-3] if rel.endswith(".gz") else rel)
    return sorted(found)


def compare_cell(ref_path: str, run_path: str) -> dict:
    ref, run = read_rows(ref_path), read_rows(run_path)
    if [r["query_id"] for r in ref] != [r["query_id"] for r in run]:
        raise ValueError(f"{run_path}: the queries differ from {ref_path}")
    differ = []
    for a, b in zip(ref, run):
        cols = {c: [a[c], b[c]] for c in COLUMNS if a[c] != b[c]}
        if cols:
            differ.append({"query_id": a["query_id"], "columns": cols})
    return {"rows": len(run), "differ": differ}


def compare_dirs(ref_dir: str, run_dir: str) -> Dict[str, dict]:
    """{cell: {"rows", "differ"}} for every cell of ``run_dir``; a cell
    missing from ``ref_dir`` raises FileNotFoundError."""
    out = {}
    for cell in cells(run_dir):
        ref = os.path.join(ref_dir, cell)
        if not (os.path.exists(ref) or os.path.exists(ref + ".gz")):
            raise FileNotFoundError(f"{cell} is missing from {ref_dir}")
        out[cell] = compare_cell(ref, os.path.join(run_dir, cell))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("ref_dir")
    p.add_argument("run_dir")
    args = p.parse_args(argv)
    try:
        result = compare_dirs(args.ref_dir, args.run_dir)
    except FileNotFoundError as exc:
        print(exc)
        return 1
    for cell, r in result.items():
        print(f"{cell}: {r['rows']} rows, {len(r['differ'])} differ")
        for d in r["differ"]:
            print("  " + json.dumps(d, ensure_ascii=False))
    if not result:
        print(f"no cells under {args.run_dir}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
