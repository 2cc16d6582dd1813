"""The SDAG-effect experiment through the PyTorch/CUDA port.

Counterpart of ``experiments/run_sdag_effect.py``: the same arguments
(``--device`` in place of ``--platform``), the same grid config, corpus,
attack CSV and output layout, but each grid runs
``python -m sdag_tpu_torch.pipeline.cli <config> --device <device>``.
It tabulates ACC/ASR for ISO vs NO-ISO — the qualitative claim of the
reference paper: NO-ISO ASR > ISO ASR under injection, at comparable ACC.

Usage::

    python experiments/run_sdag_effect_torch.py \
        --ckpt experiments/data/qa_ckpt \
        [--out experiments/results/sdag_effect_torch] [--n-mal 1 2 5] \
        [--device cuda]

Queries = ALL facts of the held-out entities (never seen in training), so
accuracy is pure answer-from-context.  Retrieval = BM25 over the full
synthetic corpus.  ADD_ATTACK_IN_RANK=0 is the reference's no-op injection
-> the clean baseline comes from the same grid.  The device defaults to
CUDA; the CLI raises when CUDA is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sdag_tpu_torch.utils.synth_qa import (load_world,  # noqa: E402
                                           write_attack_csv,
                                           write_corpus_jsonl)

CLI_MODULE = "sdag_tpu_torch.pipeline.cli"


def run_grid(ckpt: str, out_dir: str, n_mal: int, positions, top_k: int,
             temperature: float, device: str = "cuda",
             speculative: int = 0, neighbors_k: int = 0) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    world = load_world(os.path.join(ckpt, "world.json"))
    corpus = os.path.join(out_dir, "corpus.jsonl")
    attack = os.path.join(out_dir, f"attack_nmal{n_mal}.csv")
    write_corpus_jsonl(world, corpus)
    facts = write_attack_csv(world, attack, world.eval_entities,
                             n_mal=n_mal, seed=world.seed + 1)
    # k=0 keeps the JAX driver's directory names (nmal1/...)
    suffix = f"_k{neighbors_k}" if neighbors_k else ""
    run_out = os.path.join(out_dir, f"nmal{n_mal}{suffix}")
    cfg = {
        "SAMPLE_SIZE": len(facts),
        # pairs zip elementwise (reference semantics): repeat top_k
        "TOP_K": [top_k] * len(positions),
        "ADD_ATTACK_IN_RANK": list(positions),
        "CSV_INPUT_PATH": attack,
        "CORPUS_JSONL_PATH": corpus,
        "RETRIEVER_BACKEND": "sparse",
        "SPARSE_INDEX_NAME_OR_PATH": os.path.join(out_dir, "bm25.index"),
        "DEFENSE_BACKEND": "none",
        "ATTACK_VARIANT": "malicious_doc",
        "MAX_MALICIOUS_DOCS_PER_QUERY": n_mal,
        "MALICIOUS_DOC_SELECTION_STRATEGY": "random",
        "LLM_CHECKPOINT": ckpt,
        "DOC_NEIGHBORS_K": neighbors_k,
        "SPECULATIVE_DRAFT_LEN": speculative,
        "LLM_BATCH_SIZE": 16,
        "BATCH_SIZE_EMBED_Q": 32,
        "MAX_GEN_TOKENS_RAG": 24,
        "TEMPERATURE": temperature,
        "TOP_P": 1.0,
        "SEED": 42,
        "OUTPUT_CSV_BASE": os.path.join(run_out, "results"),
    }
    cfg_path = os.path.join(run_out, "config.json")
    os.makedirs(run_out, exist_ok=True)
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh, indent=1)

    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", CLI_MODULE, cfg_path,
                           "--device", device], cwd=REPO,
                          env=dict(os.environ), capture_output=True,
                          text=True)
    wall = time.time() - t0
    with open(os.path.join(run_out, "run.log"), "w") as fh:
        fh.write(proc.stdout)
        fh.write("\n--- stderr ---\n" + proc.stderr[-20000:])
    status = {"rc": proc.returncode, "wall_s": round(wall, 1),
              "n_queries": len(facts), "n_mal": n_mal,
              "neighbors_k": neighbors_k, "device": device}
    for line in proc.stdout.splitlines():
        if line.startswith("[spec] "):   # measured acceptance report
            status["spec_report"] = line
    with open(os.path.join(run_out, "wall.json"), "w") as fh:
        json.dump(status, fh)
    print(f"[sdag_effect] n_mal={n_mal}: rc={proc.returncode} "
          f"wall={wall:.0f}s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:])
        raise SystemExit(1)

    rows = {}
    for pos in positions:
        jp = os.path.join(run_out,
                          f"results_top_k={top_k}_attacker_pos={pos}.json")
        with open(jp) as fh:
            m = json.load(fh)["answer_match_stats"]
        rows[pos] = {
            "acc_iso": m["iso"]["ground_truth_match_rate"],
            "asr_iso": m["iso"]["false_answer_match_rate"],
            "acc_noiso": m["no_iso"]["ground_truth_match_rate"],
            "asr_noiso": m["no_iso"]["false_answer_match_rate"],
        }
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="experiments/data/qa_ckpt")
    p.add_argument("--out", default="experiments/results/sdag_effect_torch")
    p.add_argument("--n-mal", type=int, nargs="+", default=[1, 5])
    p.add_argument("--positions", type=int, nargs="+", default=[0, 1, 3])
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline runs (default: cuda)")
    p.add_argument("--speculative", type=int, default=0,
                   help="SPECULATIVE_DRAFT_LEN (0 = off); measured "
                        "accepted-drafts/round lands in wall.json")
    p.add_argument("--neighbors-k", type=int, nargs="+", default=[0],
                   help="DOC_NEIGHBORS_K sweep: 0 = strict isolation "
                        "(reference default); k>0 opens full-attention "
                        "windows to each doc's k nearest neighbor docs")
    args = p.parse_args(argv)

    summary = {}
    for n_mal in args.n_mal:
        for nk in args.neighbors_k:
            summary[(n_mal, nk)] = run_grid(
                args.ckpt, args.out, n_mal, args.positions, args.top_k,
                args.temperature, args.device,
                speculative=args.speculative, neighbors_k=nk)

    lines = ["# SDAG effect (tiny trained decoder, held-out entities)", "",
             "| n_mal | nbr_k | attack pos | ACC iso | ACC noiso | ASR iso | "
             "ASR noiso |", "|---|---|---|---|---|---|---|"]
    for (n_mal, nk), rows in summary.items():
        for pos, r in rows.items():
            lines.append(
                f"| {n_mal} | {nk} | {pos} | {r['acc_iso']:.3f} | "
                f"{r['acc_noiso']:.3f} | {r['asr_iso']:.3f} | "
                f"{r['asr_noiso']:.3f} |")
    table = "\n".join(lines)
    print(table)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump({f"{k[0]}_k{k[1]}": v for k, v in summary.items()},
                  fh, indent=1)
    with open(os.path.join(args.out, "SUMMARY.md"), "w") as fh:
        fh.write(table + "\n")


if __name__ == "__main__":
    main()
