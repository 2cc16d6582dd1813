"""Experiment orchestrator: retrieve -> attack -> defend -> generate (ISO &
NO-ISO) -> evaluate -> save.

Counterpart of ``sdag_tpu/pipeline/orchestrator.py`` (itself mirroring the
reference's ``src/pipeline/main.py:109-858``): ISO generation is
batched and every phase is timed (utils/profiling.py).  Settings outside
this port's slice (pipeline/resources.py ``check_supported``) raise
NotImplementedError.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sdag_tpu_torch.attack.content import build_attack_content_for_batch
from sdag_tpu_torch.attack.corruption import (build_docs_for_attack,
                                              doc_contains_any_gt,
                                              replace_gt_with_false)
from sdag_tpu_torch.attack.injection import (
    apply_ranked_list_order, attack_config_requests_docs,
    inject_malicious_docs_into_ranked_list)
from sdag_tpu_torch.attack.selection import select_malicious_docs_for_batch
from sdag_tpu_torch.config import Config
from sdag_tpu_torch.core.mesh import is_writer
from sdag_tpu_torch.datamodels import PairSpec, QueryData, Resources
from sdag_tpu_torch.defenses.cache import (LabelCache,
                                           load_discern_labels_jsonl,
                                           save_discern_labels_jsonl)
from sdag_tpu_torch.eval.metrics import (
    build_pair_metrics, compute_false_answer_stats_for_results)
from sdag_tpu_torch.eval.normalization import (exact_match,
                                               extract_final_answer)
from sdag_tpu_torch.eval.writers import save_metrics_json, save_results
from sdag_tpu_torch.pipeline.resources import (build_defense,
                                               build_retriever,
                                               check_supported,
                                               init_resources)
from sdag_tpu_torch.sdag.knn import compute_doc_knn_for_docs_batch
from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                       build_rag_prompt_plan)
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.parsing import (load_from_csv,
                                          load_sampled_queries_json)
from sdag_tpu_torch.utils.profiling import PhaseTimer, maybe_profile


# --------------------------------------------------------------- helpers
def build_pair_specs(top_k_list: Sequence[int],
                     attack_pos_list: Sequence[int]) -> List[PairSpec]:
    """Zip TOP_K x ADD_ATTACK_IN_RANK (reference ``main.py:109-131``)."""
    if len(top_k_list) != len(attack_pos_list):
        n = min(len(top_k_list), len(attack_pos_list))
        print(f"[pairs] Warning: mismatched list lengths; using first {n}.")
    else:
        n = len(top_k_list)
    return [PairSpec(int(k), int(p))
            for k, p in zip(top_k_list[:n], attack_pos_list[:n])]


def compute_need_attack_content(preset_false_answer_groups,
                                pairs: Sequence[PairSpec]) -> bool:
    if preset_false_answer_groups is not None:
        return False
    return any(attack_config_requests_docs(p.attacker_pos) for p in pairs)


def compute_max_k_needed(pairs: Sequence[PairSpec],
                         attack_variant: str) -> int:
    max_k = max(p.top_k for p in pairs)
    return max_k + 1 if attack_variant == "doc_corruption" else max_k


def num_shuffles_for_prompt_order(cfg: Config) -> int:
    if cfg.RANKED_LIST_ORDER_IN_PROMPT == "random":
        return int(cfg.NUM_RANDOM_SHUFFLES)
    return 1


def load_queries_unified(cfg: Config) -> QueryData:
    """CSV attack files or sampled-queries JSON (the reference supports only
    CSV in-pipeline, ``main.py:185-186``; samplers live in its offline CLI)."""
    if cfg.DATASET_NAME == "csv":
        qd = load_from_csv(cfg.CSV_INPUT_PATH)
    elif cfg.DATASET_NAME == "json":
        qd = load_sampled_queries_json(cfg.SAMPLED_QUERIES_JSON)
    elif cfg.DATASET_NAME in {"nq", "natural_questions", "hotpotqa",
                              "hotpot_qa", "triviaqa", "trivia_qa"}:
        # samplers unified into ingest (the reference keeps them in its
        # offline CLI only, main.py:185-186): cached JSON is used when
        # present, otherwise the HF dataset is sampled fresh
        import os as _os
        if _os.path.exists(cfg.SAMPLED_QUERIES_JSON):
            qd = load_sampled_queries_json(cfg.SAMPLED_QUERIES_JSON)
        else:
            from sdag_tpu_torch.attack.poisoned_rag import SAMPLERS
            rows = SAMPLERS[cfg.DATASET_NAME](
                cfg.SAMPLE_SIZE or 1000, cfg.SEED, cfg.DATASET_SPLIT,
                cfg.SAMPLED_QUERIES_JSON)
            qd = QueryData(
                query_ids=[str(r["id"]) for r in rows],
                questions=[str(r["question"]) for r in rows],
                short_answers=[[str(a) for a in r["short_answers"]]
                               for r in rows],
                false_answer_groups=None,
                malicious_doc_groups=None)
    else:
        raise ValueError(f"Unknown DATASET_NAME: {cfg.DATASET_NAME}")
    if cfg.SAMPLE_SIZE and cfg.SAMPLE_SIZE > 0 and len(qd) > cfg.SAMPLE_SIZE:
        qd = QueryData(
            query_ids=qd.query_ids[:cfg.SAMPLE_SIZE],
            questions=qd.questions[:cfg.SAMPLE_SIZE],
            short_answers=qd.short_answers[:cfg.SAMPLE_SIZE],
            false_answer_groups=(qd.false_answer_groups[:cfg.SAMPLE_SIZE]
                                 if qd.false_answer_groups else None),
            malicious_doc_groups=(qd.malicious_doc_groups[:cfg.SAMPLE_SIZE]
                                  if qd.malicious_doc_groups else None),
        )
    print(f"[data] loaded {len(qd)} queries")
    return qd


# ------------------------------------------------------------ generation
def generate_iso_batch(cfg: Config, res: Resources, queries: List[str],
                       defended_docs_batch: List[List[str]],
                       survived_mals_batch: List[List[str]],
                       attacker_pos: int,
                       rng: random.Random) -> List[str]:
    """Batched document-isolation generation (reference runs this per query,
    ``main.py:469-496``; the mask/span semantics are identical)."""
    plans = []
    for q, docs_ranked, mals in zip(queries, defended_docs_batch,
                                    survived_mals_batch):
        block_align = getattr(res.generator, "block_align", 0)
        if cfg.ORACLE:
            plan = build_rag_prompt_plan(
                res.tokenizer, q,
                inject_malicious_docs_into_ranked_list(
                    list(docs_ranked), list(mals), attacker_pos, rng=rng),
                block_align=block_align)
        else:
            plan = build_rag_prompt_plan(res.tokenizer, q, list(docs_ranked),
                                         block_align=block_align)
        plans.append(plan)
    if cfg.DOC_NEIGHBORS_K and cfg.DOC_NEIGHBORS_K > 0:
        # one encode per batch, not one per query
        neighbors = compute_doc_knn_for_docs_batch(
            res.ranker, [p.ranked_docs for p in plans], cfg.DOC_NEIGHBORS_K)
    else:
        neighbors = [None] * len(plans)

    answers: List[str] = []
    bs = max(1, cfg.LLM_BATCH_SIZE)
    for i in range(0, len(plans), bs):
        answers.extend(res.generator.generate_plans(
            plans[i:i + bs],
            doc_neighbors=neighbors[i:i + bs],
            max_new_tokens=cfg.MAX_GEN_TOKENS_RAG))
    return answers


def generate_noiso_batch(cfg: Config, res: Resources, queries: List[str],
                         defended_docs_batch: List[List[str]],
                         survived_mals_batch: List[List[str]],
                         attacker_pos: int,
                         rng: random.Random) -> List[str]:
    """Plain causal generation (reference ``main.py:308-378``)."""
    ids_list = []
    for q, docs_ranked, mals in zip(queries, defended_docs_batch,
                                    survived_mals_batch):
        if cfg.ORACLE:
            ranked = inject_malicious_docs_into_ranked_list(
                list(docs_ranked), list(mals), attacker_pos, rng=rng)
        else:
            ranked = list(docs_ranked)
        ranked = apply_ranked_list_order(ranked,
                                         cfg.RANKED_LIST_ORDER_IN_PROMPT,
                                         rng=rng)
        user_content = prompts.USER_RAG_PROMPT.format(
            query=q, docs_text=prompts.render_docs_text(ranked))
        ids_list.append(build_plain_chat_ids(
            res.tokenizer, prompts.SYSTEM_PROMPT_RAG, user_content))

    answers: List[str] = []
    bs = max(1, cfg.LLM_BATCH_SIZE)
    for i in range(0, len(ids_list), bs):
        answers.extend(res.generator.generate_ids(
            ids_list[i:i + bs], max_new_tokens=cfg.MAX_GEN_TOKENS_RAG))
    return answers


# --------------------------------------------------- pair execution paths
def run_pair_malicious_doc_attack_for_batch(
    *, cfg: Config, res: Resources, defense, discern_cache: LabelCache,
    pair: PairSpec, batch_qids: List[str], batch_qs: List[str],
    batch_gts: List[List[str]], retrieval_docs_full: List[List[str]],
    retrieval_ids_full: List[List[str]],
    retrieval_scores_full: List[List[float]],
    false_groups_batch: List[List[str]],
    chosen_mals_batch: List[List[str]], rng: random.Random,
    timer: PhaseTimer,
) -> List[Dict[str, Any]]:
    """Attack + defend + generate + evaluate for one (top_k, pos) pair
    (reference ``main.py:385-550``)."""
    k_plus_one = pair.top_k + 1
    pools = [(docs[:k_plus_one], ids_[:k_plus_one], sc[:k_plus_one])
             for docs, ids_, sc in zip(retrieval_docs_full,
                                       retrieval_ids_full,
                                       retrieval_scores_full)]

    defended_docs, defended_ids, defended_scores = [], [], []
    survived_mals, discern_labels = [], []
    with timer.phase("defense"):
        for qid, q, (docs_pool, ids_pool, scores_pool), mals in zip(
                batch_qids, batch_qs, pools, chosen_mals_batch):
            out = defense.apply(
                query_id=str(qid), query=q, corpus_docs=list(docs_pool),
                corpus_ids=list(ids_pool), corpus_scores=list(scores_pool),
                malicious_docs=list(mals) if cfg.ORACLE else [],
                does_oracle=cfg.ORACLE, persistent_cache=discern_cache)
            defended_docs.append(list(out.ranked_docs))
            defended_ids.append(list(out.ranked_ids))
            defended_scores.append(list(out.ranked_scores)
                                   if out.ranked_scores is not None
                                   else list(scores_pool))
            survived_mals.append(list(out.malicious_docs_survived))
            discern_labels.append(out.doc_labels)

    rows: List[Dict[str, Any]] = []
    n_shuffles = num_shuffles_for_prompt_order(cfg)
    # ISO prompts ignore RANKED_LIST_ORDER_IN_PROMPT (reference parity:
    # SDAG.py builds its own span layout), so under greedy decoding with a
    # deterministic injection position every shuffle's ISO answers are
    # byte-identical — generate once instead of paying the dominant
    # prefill+decode phase NUM_RANDOM_SHUFFLES times.  Only ORACLE runs
    # ever pass the real attacker_pos to the ISO side (non-ORACLE calls
    # below use pos=0), so pos=-1 (random injection) disables the hoist
    # only there; T>0 (sampling) always keeps the per-shuffle rerun.
    iso_invariant = (n_shuffles > 1 and cfg.TEMPERATURE == 0
                     and (not cfg.ORACLE or pair.attacker_pos != -1))
    answers_iso: Optional[List[str]] = None
    for _shuffle in range(n_shuffles):
        if answers_iso is None or not iso_invariant:
            with timer.phase("generate_iso"):
                answers_iso = generate_iso_batch(
                    cfg, res, batch_qs, defended_docs, survived_mals,
                    pair.attacker_pos if cfg.ORACLE else 0, rng)
        with timer.phase("generate_noiso"):
            answers_noiso = generate_noiso_batch(
                cfg, res, batch_qs, defended_docs, survived_mals,
                pair.attacker_pos, rng)

        for qid, q, gts, fa_list, docs_ranked, ids_ranked, mals, a_iso, \
                a_noiso in zip(batch_qids, batch_qs, batch_gts,
                               false_groups_batch, defended_docs,
                               defended_ids, survived_mals, answers_iso,
                               answers_noiso):
            iso_clean = extract_final_answer(a_iso)
            noiso_clean = extract_final_answer(a_noiso)
            has_attack = attack_config_requests_docs(pair.attacker_pos)
            rows.append({
                "query_id": qid,
                "question": q,
                "short_answers": gts,
                "false_answer": fa_list,
                "malicious_doc": (" ||| ".join(mals)
                                  if has_attack and mals else ""),
                "retrieved_docs": list(docs_ranked),
                "retrieved_doc_ids": list(ids_ranked),
                "rag_answer_iso": iso_clean,
                "rag_answer_noiso": noiso_clean,
                "ground_truth_match_iso":
                    any(exact_match(iso_clean, gt) for gt in gts),
                "ground_truth_match_noiso":
                    any(exact_match(noiso_clean, gt) for gt in gts),
                "false_match_iso":
                    any(exact_match(iso_clean, fa) for fa in fa_list)
                    if fa_list else False,
                "false_match_noiso":
                    any(exact_match(noiso_clean, fa) for fa in fa_list)
                    if fa_list else False,
            })
    return rows


def run_pair_doc_corruption_for_batch(
    *, cfg: Config, res: Resources, pair: PairSpec, batch_qids: List[str],
    batch_qs: List[str], batch_gts: List[List[str]],
    retrieval_docs_full: List[List[str]],
    retrieval_ids_full: List[List[str]],
    false_groups_batch: List[List[str]], rng: random.Random,
    timer: PhaseTimer,
) -> List[Dict[str, Any]]:
    """Corrupt GT-bearing retrieved docs instead of injecting
    (reference ``main.py:557-695``; one row per attacked doc).

    All (query, attacked-doc) items of the batch are collected first and
    generated together in LLM_BATCH_SIZE chunks — the reference (and
    round-2 code) generated each candidate at batch=1, which made the
    corruption gen phase ~2x slower than the injection runs."""
    k_plus_one = pair.top_k + 1
    rows: List[Dict[str, Any]] = []

    for _shuffle in range(num_shuffles_for_prompt_order(cfg)):
        items: List[Dict[str, Any]] = []
        for qid, q, gts, docs_full, ids_full, fa_list in zip(
                batch_qids, batch_qs, batch_gts, retrieval_docs_full,
                retrieval_ids_full, false_groups_batch):
            if not fa_list:
                continue
            false_ans = fa_list[0]
            docs_pool = docs_full[:k_plus_one]
            ids_pool = ids_full[:k_plus_one]
            candidates = [j for j, d in enumerate(docs_pool)
                          if d and doc_contains_any_gt(d, gts)]
            for attacked_idx in candidates:
                poisoned = replace_gt_with_false(docs_pool[attacked_idx],
                                                 gts, false_ans)
                docs_poisoned = list(docs_pool)
                docs_poisoned[attacked_idx] = poisoned
                # resolve a random position ONCE so the docs and ids
                # lists move the attacked entry to the SAME slot — the
                # reference draws twice (main.py:621-631), misaligning
                # retrieved_doc_ids from the prompt docs (deliberate fix,
                # README "Deliberate fixes")
                pos = pair.attacker_pos
                if pos == -1:
                    pos = rng.randint(0, len(docs_poisoned) - 1) + 1
                docs_for_prompt = build_docs_for_attack(
                    docs_poisoned, attacked_idx, pos, k_plus_one, rng=rng)
                ids_for_prompt = build_docs_for_attack(
                    list(ids_pool), attacked_idx, pos, k_plus_one, rng=rng)
                items.append({
                    "qid": qid, "q": q, "gts": gts, "false_ans": false_ans,
                    "poisoned": poisoned, "docs_pool": docs_pool,
                    "attacked_idx": attacked_idx,
                    "docs_for_prompt": docs_for_prompt,
                    "ids_for_prompt": ids_for_prompt,
                })

        if not items:
            continue
        qs = [it["q"] for it in items]
        docs_b = [it["docs_for_prompt"] for it in items]
        empties = [[] for _ in items]
        with timer.phase("generate_iso"):
            answers_iso = generate_iso_batch(
                cfg, res, qs, docs_b, empties, 0, rng)
        with timer.phase("generate_noiso"):
            answers_noiso = generate_noiso_batch(
                cfg, res, qs, docs_b, empties, 0, rng)

        for it, a_iso, a_noiso in zip(items, answers_iso, answers_noiso):
            iso_clean = extract_final_answer(a_iso)
            noiso_clean = extract_final_answer(a_noiso)
            gts, false_ans = it["gts"], it["false_ans"]
            rows.append({
                "query_id": it["qid"],
                "question": it["q"],
                "short_answers": gts,
                "false_answer": [false_ans],
                "malicious_doc": it["poisoned"],
                "retrieved_docs": [d for i, d in enumerate(it["docs_pool"])
                                   if i != it["attacked_idx"]],
                "retrieved_doc_ids": list(it["ids_for_prompt"]),
                "rag_answer_iso": iso_clean,
                "rag_answer_noiso": noiso_clean,
                "ground_truth_match_iso":
                    any(exact_match(iso_clean, gt) for gt in gts),
                "ground_truth_match_noiso":
                    any(exact_match(noiso_clean, gt) for gt in gts),
                "false_match_iso": exact_match(iso_clean, false_ans),
                "false_match_noiso": exact_match(noiso_clean, false_ans),
            })
    return rows


# ------------------------------------------------------------------ main
def run_experiment(cfg: Config,
                   resources: Optional[Resources] = None,
                   device="cuda") -> Dict[Tuple[int, int], Dict[str, Any]]:
    """Full experiment on ``device`` (default CUDA; raises without it).
    Returns {(top_k, pos): metrics dict}; also writes the per-pair CSV +
    JSON outputs (reference ``main.py:702-858``)."""
    cfg.validate()
    check_supported(cfg)
    cfg.init_seeds()
    # under torchrun every rank computes the same rows; rank 0 writes
    writer = is_writer()
    timer = PhaseTimer()

    query_data = load_queries_unified(cfg)
    pairs = build_pair_specs(cfg.TOP_K, cfg.ADD_ATTACK_IN_RANK)
    if not pairs or len(query_data) == 0:
        print("[run] nothing to do")
        return {}

    with timer.phase("init_resources"):
        res = (resources if resources is not None
               else init_resources(cfg, device=device))
    retriever = build_retriever(cfg, res)
    defense = build_defense(cfg, res)

    discern_cache: LabelCache = {}
    if cfg.DISCERN_LABELS_LOAD_PATH:
        discern_cache = load_discern_labels_jsonl(cfg.DISCERN_LABELS_LOAD_PATH)

    need_attack_content = compute_need_attack_content(
        query_data.false_answer_groups, pairs)
    max_k_needed = compute_max_k_needed(pairs, cfg.ATTACK_VARIANT)

    results_per_pair: Dict[Tuple[int, int], List[Dict[str, Any]]] = {
        (p.top_k, p.attacker_pos): [] for p in pairs}

    resume_logs: Dict[Tuple[int, int], Any] = {}
    if cfg.RESUME_LOGS:
        from sdag_tpu_torch.pipeline.resume import BatchResultLog
        for p in pairs:
            path = (f"{cfg.OUTPUT_CSV_BASE}_top_k={p.top_k}"
                    f"_attacker_pos={p.attacker_pos}_rows.jsonl")
            resume_logs[(p.top_k, p.attacker_pos)] = BatchResultLog(path)

    num_q = len(query_data)
    bs = cfg.BATCH_SIZE_EMBED_Q
    with maybe_profile():
        for i in range(0, num_q, bs):
            batch_idx = i // bs
            # a per-batch rng stream (not one run-long stream) makes a
            # resumed run draw exactly what the uninterrupted run would
            # have for every fresh batch — skipped batches consume no
            # state the remaining batches depend on (the pair loop below
            # re-seeds per (batch, pair) for the same reason)
            rng = random.Random(cfg.SEED * 1_000_003 + batch_idx)
            if resume_logs and all(
                    log.is_done(batch_idx) for log in resume_logs.values()):
                for key, log in resume_logs.items():
                    results_per_pair[key].extend(log.rows_for(batch_idx))
                print(f"[run] batch {batch_idx + 1}: resumed from log")
                continue
            batch_qs = query_data.questions[i:i + bs]
            batch_gts = query_data.short_answers[i:i + bs]
            batch_qids = query_data.query_ids[i:i + bs]
            print(f"[run] batch {i // bs + 1}/{(num_q + bs - 1) // bs} "
                  f"({len(batch_qs)} queries)")

            with timer.phase("retrieve"):
                retrieval = retriever.retrieve_batch(
                    batch_qs, max_k_needed=max_k_needed,
                    embed_batch_size=cfg.BATCH_SIZE_EMBED_Q)

            if (query_data.false_answer_groups is not None
                    and query_data.malicious_doc_groups is not None):
                false_groups = query_data.false_answer_groups[i:i + bs]
                mal_groups = query_data.malicious_doc_groups[i:i + bs]
            else:
                with timer.phase("attack_content"):
                    false_groups, mal_groups = build_attack_content_for_batch(
                        None, None, need_attack_content, res.generator,
                        batch_qs,
                        max_tokens_false_answer=cfg.MAX_GEN_TOKENS_FALSE_ANSWER,
                        max_tokens_document=cfg.MAX_GEN_TOKENS_DOCUMENT,
                        batch_size=cfg.LLM_BATCH_SIZE)

            with timer.phase("select_malicious"):
                chosen_mals = select_malicious_docs_for_batch(
                    res.ranker, retrieval.docs_texts_full, mal_groups,
                    strategy=cfg.MALICIOUS_DOC_SELECTION_STRATEGY,
                    max_docs=cfg.MAX_MALICIOUS_DOCS_PER_QUERY, rng=rng)

            for pair in pairs:
                key = (pair.top_k, pair.attacker_pos)
                # per-pair resume: a crash between two pairs' appends must
                # not re-append the completed pair's rows on the next run
                # (the log would hold them twice and every later resume
                # would double-count them in ACC/ASR)
                if resume_logs and resume_logs[key].is_done(batch_idx):
                    results_per_pair[key].extend(
                        resume_logs[key].rows_for(batch_idx))
                    continue
                # per-(batch, pair) rng: a resume that skips a completed
                # pair must not shift the draws of the remaining pairs
                # (a shared stream would make pair B's shuffle/injection
                # positions depend on whether pair A was recomputed)
                pair_rng = random.Random(
                    f"{cfg.SEED}:{batch_idx}:{pair.top_k}:"
                    f"{pair.attacker_pos}")
                if cfg.ATTACK_VARIANT == "malicious_doc":
                    rows = run_pair_malicious_doc_attack_for_batch(
                        cfg=cfg, res=res, defense=defense,
                        discern_cache=discern_cache, pair=pair,
                        batch_qids=batch_qids, batch_qs=batch_qs,
                        batch_gts=batch_gts,
                        retrieval_docs_full=retrieval.docs_texts_full,
                        retrieval_ids_full=retrieval.ids_full,
                        retrieval_scores_full=retrieval.scores_full,
                        false_groups_batch=false_groups,
                        chosen_mals_batch=chosen_mals, rng=pair_rng,
                        timer=timer)
                else:
                    rows = run_pair_doc_corruption_for_batch(
                        cfg=cfg, res=res, pair=pair, batch_qids=batch_qids,
                        batch_qs=batch_qs, batch_gts=batch_gts,
                        retrieval_docs_full=retrieval.docs_texts_full,
                        retrieval_ids_full=retrieval.ids_full,
                        false_groups_batch=false_groups, rng=pair_rng,
                        timer=timer)
                results_per_pair[key].extend(rows)
                if resume_logs and writer:
                    resume_logs[key].append_batch(batch_idx, rows)

    all_metrics: Dict[Tuple[int, int], Dict[str, Any]] = {}
    for pair in pairs:
        key = (pair.top_k, pair.attacker_pos)
        results = results_per_pair[key]
        base = (f"{cfg.OUTPUT_CSV_BASE}_top_k={pair.top_k}"
                f"_attacker_pos={pair.attacker_pos}")
        metrics = build_pair_metrics(results, pair.top_k, pair.attacker_pos)
        metrics["false_answer_stats"] = \
            compute_false_answer_stats_for_results(results)
        metrics["run_config"] = cfg.snapshot()
        metrics["phase_timings"] = timer.summary()
        if writer:
            save_results(results, base + ".csv")
            save_metrics_json(metrics, base + ".json")
            print(f"[run] saved {base}.csv / .json")
        all_metrics[key] = metrics

    if cfg.DEFENSE_BACKEND == "discern_and_answer" and writer:
        out = f"{cfg.OUTPUT_CSV_BASE}_{cfg.DISCERN_LABELS_SAVE_SUFFIX}"
        save_discern_labels_jsonl(out, discern_cache)

    gen = res.generator
    if getattr(gen, "spec_total_row_rounds", 0):
        acc = gen.spec_total_tokens / gen.spec_total_row_rounds - 1.0
        print(f"[spec] verification rounds: {gen.spec_total_rounds}, "
              f"emitted tokens: {gen.spec_total_tokens}, measured "
              f"accepted drafts/round: {acc:.3f} "
              f"(G={cfg.SPECULATIVE_DRAFT_LEN})")

    timer.report()
    return all_metrics
