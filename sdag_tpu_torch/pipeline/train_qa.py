"""Train a tiny decoder on synthetic answer-from-context QA.

Counterpart of ``sdag_tpu/pipeline/train_qa.py``: the model that shows the
paper's effect (document isolation, ISO, against causal NO-ISO attention
under poisoning) needs ACC well above zero, and no pretrained checkpoint
exists offline, so this trains one on the synthetic world of
``utils/synth_qa.py`` with the port's train step (``parallel/train.py``)
and prompt planner (``sdag/spans.py``), then saves a native checkpoint the
pipeline loads via ``LLM_CHECKPOINT`` (``models/native_ckpt.py``).

The examples, batches and wire stacks equal the JAX module's for the same
``np.random.Generator``, bit for bit; so do the flags.  Faithfulness notes
(the JAX module's): training prompts are built by the code path the
pipeline serves with; examples mix ISO-masked and causal prefills; the
training data is clean (no poisoned documents); ~25% of entities are held
out, and evaluation on them shows the model reads the context.

CLI (the JAX flags, with ``--device`` for the platform)::

    python -m sdag_tpu_torch.pipeline.train_qa --out ckpt_dir [--steps 3000]
        [--device cpu]       # default cuda (cuda:LOCAL_RANK under torchrun)
    torchrun --nproc-per-node 2 -m sdag_tpu_torch.pipeline.train_qa \\
        --out ckpt_dir --mesh-data 2           # rank 0 writes
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdag_tpu_torch.core.mesh import (is_writer, make_mesh,
                                      maybe_init_distributed, rank_device)
from sdag_tpu_torch.models.llama import (DecoderConfig, init_decoder_params,
                                         prefill)
from sdag_tpu_torch.models.native_ckpt import save_decoder
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.parallel.train import (AdamW, make_sharded_train_scan,
                                           make_sharded_train_step,
                                           warmup_cosine_decay_schedule)
from sdag_tpu_torch.sdag.spans import build_rag_prompt_plan
from sdag_tpu_torch.utils.synth_qa import (Fact, fact_doc, fact_query,
                                           make_world, random_fact,
                                           save_world, styled_fact_doc)
from sdag_tpu_torch.utils.tree import tree_leaves

AUX_LM_WEIGHT = 0.1


def build_example(rng: np.random.Generator, tokenizer, fact: Fact,
                  pool: Optional[List[Fact]], k: int, iso: bool,
                  seq_len: int, styled_frac: float = 0.3,
                  dup_frac: float = 0.25,
                  nbr_frac: float = 0.0,
                  answer_form: str = "value",
                  ) -> Optional[Dict[str, np.ndarray]]:
    """One training example: k-doc RAG prompt (GT doc at a random rank,
    distractors drawn from other facts) + the answer.  Loss weights: 1.0
    on the answer tokens, AUX_LM_WEIGHT on the whole prompt.  iso=True
    applies the SDAG doc metadata at prefill; iso=False is the plain
    causal (NO-ISO) prefill.  pool=None draws fresh random distractor
    facts (stream mode).  Docs render as the plain template or, with
    probability ``styled_frac``, the poison surface form with the true
    value; with probability ``dup_frac`` the GT fact repeats 2..k times;
    ``nbr_frac`` of ISO examples get random neighbor windows (1..4 other
    docs each, the mask family ``DOC_NEIGHBORS_K`` serving produces).
    ``answer_form="sentence"`` targets the doc's whole sentence.  The JAX
    module's docstring has the measurements behind each choice."""
    def render(f: Fact) -> str:
        if rng.random() < styled_frac:
            return styled_fact_doc(f, int(rng.integers(0, 5)))
        return fact_doc(f)

    n_gt = 1
    if k >= 2 and rng.random() < dup_frac:
        n_gt = int(rng.integers(2, k + 1))
    if pool is None:
        docs = [render(random_fact(rng)) for _ in range(k - n_gt)]
    else:
        others = [f for f in pool if f is not fact]
        picks = rng.choice(len(others), size=min(k - n_gt, len(others)),
                           replace=False)
        docs = [render(others[int(i)]) for i in picks]
    for _ in range(n_gt):
        docs.insert(int(rng.integers(0, len(docs) + 1)), render(fact))
    plan = build_rag_prompt_plan(tokenizer, fact_query(fact), docs)
    # the mid-sentence surface form (" value"), as the retrieved doc has it
    if answer_form == "sentence":
        ans_text = " " + fact_doc(fact)
    else:
        ans_text = " " + fact.value
    ans = (tokenizer.encode(ans_text, add_special_tokens=False)
           + [tokenizer.eos_token_id])
    ids = list(plan.input_ids) + ans
    if len(ids) > seq_len:
        return None
    neighbors = None
    n_docs = len(docs)
    if iso and n_docs > 1 and rng.random() < nbr_frac:
        nbr_k = int(rng.integers(1, 5))
        neighbors = [rng.choice([j for j in range(n_docs) if j != i],
                                size=min(nbr_k, n_docs - 1),
                                replace=False).tolist()
                     for i in range(n_docs)]
    doc_id, nbr_bits, sys_len = plan.metadata(doc_neighbors=neighbors,
                                              pad_to=seq_len)
    if not iso:
        doc_id = np.full_like(doc_id, -1)
        sys_len = 0
    prompt_len = len(plan.input_ids)
    input_ids = np.full(seq_len, tokenizer.pad_token_id, np.int32)
    input_ids[:len(ids)] = ids
    targets = np.zeros(seq_len, np.int32)
    targets[:len(ids) - 1] = ids[1:]
    loss_mask = np.zeros(seq_len, np.float32)
    loss_mask[:len(ids) - 1] = AUX_LM_WEIGHT       # aux LM on the prompt
    loss_mask[prompt_len - 1:len(ids) - 1] = 1.0   # predicts the answer
    return {"input_ids": input_ids, "targets": targets, "doc_id": doc_id,
            "nbr_bits": nbr_bits,
            "sys_user_len": np.int32(sys_len),
            "valid_len": np.int32(len(ids)), "loss_mask": loss_mask}


def _collect_examples(n: int, make_one) -> List[Dict[str, np.ndarray]]:
    """Rejection-sample n examples (build_example returns None when the
    prompt does not fit seq_len)."""
    exs: List[Dict[str, np.ndarray]] = []
    while len(exs) < n:
        ex = make_one()
        if ex is not None:
            exs.append(ex)
    return exs


def _train_example(rng: np.random.Generator, tokenizer,
                   pool: Optional[List[Fact]], seq_len: int, k_min: int,
                   k_max: int, iso_frac: float, styled_frac: float,
                   dup_frac: float, nbr_frac: float = 0.0,
                   answer_form: str = "value"):
    """One training example: fresh pseudoword fact in stream mode
    (pool=None), random doc count, coin-flipped ISO/causal prefill."""
    fact = random_fact(rng) if pool is None \
        else pool[int(rng.integers(len(pool)))]
    k = int(rng.integers(k_min, k_max + 1))
    return build_example(rng, tokenizer, fact, pool, k,
                         iso=bool(rng.random() < iso_frac),
                         seq_len=seq_len, styled_frac=styled_frac,
                         dup_frac=dup_frac, nbr_frac=nbr_frac,
                         answer_form=answer_form)


def _stack(exs: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    return {key: torch.from_numpy(np.stack([e[key] for e in exs]))
            for key in exs[0]}


def sample_batch(rng: np.random.Generator, tokenizer,
                 pool: Optional[List[Fact]], batch: int, seq_len: int,
                 k_min: int = 2, k_max: int = 10,
                 iso_frac: float = 0.5, styled_frac: float = 0.3,
                 dup_frac: float = 0.25,
                 nbr_frac: float = 0.0,
                 answer_form: str = "value") -> Dict[str, torch.Tensor]:
    """pool=None = stream mode: every example's facts are fresh
    pseudowords, so the model can only learn answer-from-context.  CPU
    tensors; a train step moves them."""
    return _stack(_collect_examples(batch, lambda: _train_example(
        rng, tokenizer, pool, seq_len, k_min, k_max, iso_frac,
        styled_frac, dup_frac, nbr_frac, answer_form)))


# Wire dtypes of a stacked upload (the JAX module's): ids in int16, doc_id
# in int8 (<= 31 docs), loss_mask in f16 (fractional aux weights); nbr_bits
# is a bitmask over doc ids and rides as int32.  Decompressed on the device
# inside the scan.
_WIRE_DTYPES = {"input_ids": np.int16, "targets": np.int16,
                "doc_id": np.int8, "nbr_bits": np.int32,
                "sys_user_len": np.int32, "valid_len": np.int32,
                "loss_mask": np.float16}


def compress_batch_np(exs: List[Dict[str, np.ndarray]]
                      ) -> Dict[str, np.ndarray]:
    return {k: np.stack([e[k] for e in exs]).astype(dt)
            for k, dt in _WIRE_DTYPES.items()}


def decompress_batch(batch):
    out = {k: batch[k].to(torch.int32) for k in
           ("input_ids", "targets", "doc_id", "nbr_bits",
            "sys_user_len", "valid_len")}
    out["loss_mask"] = batch["loss_mask"].to(torch.float32)
    return out


def sample_batch_stack(rng: np.random.Generator, tokenizer,
                       pool: Optional[List[Fact]], chunk: int, batch: int,
                       seq_len: int, k_min: int = 2, k_max: int = 10,
                       iso_frac: float = 0.5, styled_frac: float = 0.3,
                       dup_frac: float = 0.25,
                       nbr_frac: float = 0.0,
                       answer_form: str = "value") -> Dict[str, np.ndarray]:
    """[S, B, ...] stack of S compressed batches for the scan driver."""
    stacks = []
    for _ in range(chunk):
        exs = _collect_examples(batch, lambda: _train_example(
            rng, tokenizer, pool, seq_len, k_min, k_max, iso_frac,
            styled_frac, dup_frac, nbr_frac, answer_form))
        stacks.append(compress_batch_np(exs))
    return {k: np.stack([s[k] for s in stacks]) for k in stacks[0]}


@torch.no_grad()
def teacher_forced_eval(params, cfg: DecoderConfig, tokenizer,
                        eval_pool: List[Fact], distract_pool: List[Fact],
                        seq_len: int, n: int = 32, k: int = 5,
                        seed: int = 123,
                        answer_form: str = "value") -> Dict[str, float]:
    """Answer-token argmax accuracy on held-out entities, per mode.
    full = all answer tokens of an example correct (proxy for gen ACC).
    Runs the dense-mask attention (``attn_impl="xla"``, as the JAX eval)
    on the parameters' device."""
    rng = np.random.default_rng(seed)
    dev = params["embed"].device
    out = {}
    for mode, iso, nf in (("iso", True, 0.0), ("noiso", False, 0.0),
                          ("iso_nbr", True, 1.0)):
        def one():
            fact = eval_pool[int(rng.integers(len(eval_pool)))]
            return build_example(rng, tokenizer, fact,
                                 distract_pool + [fact], k, iso=iso,
                                 seq_len=seq_len, nbr_frac=nf,
                                 answer_form=answer_form)

        batch = {key: v.to(dev) for key, v in
                 _stack(_collect_examples(n, one)).items()}
        logits, _ = prefill(
            params, cfg, batch["input_ids"], doc_id=batch["doc_id"],
            nbr_bits=batch["nbr_bits"], sys_user_len=batch["sys_user_len"],
            valid_len=batch["valid_len"], with_cache=False,
            attn_impl="xla")
        pred = logits.argmax(-1).cpu().numpy()
        # answer tokens only (weight exactly 1.0; aux-LM prompt weights
        # are fractional)
        m = batch["loss_mask"].cpu().numpy() == 1.0
        tgt = batch["targets"].cpu().numpy()
        tok_acc = float((pred[m] == tgt[m]).mean())
        full = float(np.mean([
            (pred[i][m[i]] == tgt[i][m[i]]).all() for i in range(n)]))
        out[f"tok_acc_{mode}"] = round(tok_acc, 4)
        out[f"full_acc_{mode}"] = round(full, 4)
    return out


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="sdag_tpu_torch.pipeline.train_qa")
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--entities", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d-model", type=int, default=192)
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--heads", type=int, default=6)
    p.add_argument("--kv-heads", type=int, default=6)
    p.add_argument("--d-ff", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=768)
    p.add_argument("--k-max", type=int, default=10)
    p.add_argument("--eval-every", type=int, default=250)
    p.add_argument("--styled-frac", type=float, default=0.3,
                   help="fraction of docs rendered in the poison surface "
                        "template with the TRUE value")
    p.add_argument("--dup-frac", type=float, default=0.25,
                   help="fraction of contexts repeating the GT fact 2..k "
                        "times")
    p.add_argument("--nbr-frac", type=float, default=0.25,
                   help="fraction of ISO examples rendered with random "
                        "neighbor windows (1..4 random docs each)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel ranks (torchrun); 0 = the world")
    p.add_argument("--scan-chunk", type=int, default=25,
                   help="steps per uploaded stack of batches; 1 = one "
                        "batch per step")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N steps")
    p.add_argument("--init-from", default="",
                   help="warm-start params from a native checkpoint dir "
                        "(same arch + tokenizer); optimizer state restarts "
                        "fresh")
    p.add_argument("--answer-form", choices=["value", "sentence"],
                   default="value",
                   help="answer target: bare ' value' or the retrieved "
                        "doc's full sentence")
    p.add_argument("--eval-n", type=int, default=32,
                   help="held-out eval examples per mode")
    p.add_argument("--tokenizer", choices=["byte", "word"], default="byte",
                   help="word = closed-vocab WordTokenizer over the synth "
                        "world; saved with the checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, cuda:LOCAL_RANK "
                        "under torchrun)")
    return p.parse_args(argv)


def make_tokenizer(kind: str):
    if kind == "word":
        from sdag_tpu_torch.models.tokenizer import WordTokenizer
        from sdag_tpu_torch.utils.synth_qa import synth_word_vocab
        return WordTokenizer(synth_word_vocab())
    return ByteTokenizer()


def round_steps(steps: int, chunk: int) -> int:
    """Steps rounded up to a multiple of the scan chunk (one stack shape
    for the whole run; extra steps only train)."""
    return ((steps + chunk - 1) // chunk) * chunk if chunk > 1 else steps


def make_training(args: argparse.Namespace, cfg: DecoderConfig, dev):
    """(init_state, step fn, scan fn or None) of a run: the optax recipe
    (warmup cosine to 3% of lr, AdamW with weight decay 0.01) over the
    data mesh."""
    mesh = make_mesh(data=args.mesh_data, model=1, device=dev)
    sched = warmup_cosine_decay_schedule(0.0, args.lr, args.warmup,
                                         args.steps, args.lr * 0.03)
    opt = AdamW(sched, weight_decay=0.01)
    if args.scan_chunk > 1:
        init_state, scan_fn = make_sharded_train_scan(
            cfg, mesh, optimizer=opt, preprocess=decompress_batch)
        return init_state, None, scan_fn
    init_state, step_fn = make_sharded_train_step(cfg, mesh, optimizer=opt)
    return init_state, step_fn, None


def sample_kwargs(args: argparse.Namespace) -> Dict[str, Any]:
    """The flags ``sample_batch`` / ``sample_batch_stack`` take."""
    return dict(k_min=args.k_min, k_max=args.k_max,
                styled_frac=args.styled_frac, dup_frac=args.dup_frac,
                nbr_frac=args.nbr_frac, answer_form=args.answer_form)


def initial_params(args: argparse.Namespace, cfg: DecoderConfig, dev):
    if args.init_from:
        from sdag_tpu_torch.models.native_ckpt import load_decoder
        params, init_cfg = load_decoder(args.init_from, device=dev)
        if init_cfg != cfg:
            raise SystemExit(f"--init-from arch mismatch: ckpt {init_cfg} "
                             f"vs requested {cfg}")
        print(f"[train_qa] warm-started from {args.init_from}", flush=True)
        return params
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    return init_decoder_params(gen, cfg, device=dev)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train, evaluate and save; returns the run's per-step losses, its
    final eval, the host seconds spent sampling batches and the seconds
    in the steps (the losses read back, so the device has finished),
    tokens trained (valid, padded) and the final state."""
    args = parse_args(argv)
    dev = rank_device(args.device)
    owns_group = not dist.is_initialized() and maybe_init_distributed(dev)
    try:
        return _run(args, dev)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, dev) -> Dict[str, Any]:
    world = make_world(args.entities, seed=args.seed)
    tokenizer = make_tokenizer(args.tokenizer)
    cfg = DecoderConfig(vocab_size=tokenizer.vocab_size,
                        d_model=args.d_model, n_layers=args.layers,
                        n_heads=args.heads, n_kv_heads=args.kv_heads,
                        d_ff=args.d_ff)
    # stream training (pool=None): fresh pseudoword facts every batch; the
    # fixed world serves evaluation and the poisoning experiment
    train_pool = None
    eval_pool = world.facts_for(world.eval_entities)
    eval_distract = world.facts_for(world.train_entities)
    print(f"[train_qa] world: {len(world.facts)} facts, "
          f"{len(world.train_entities)} train / "
          f"{len(world.eval_entities)} eval entities", flush=True)

    chunk = max(1, args.scan_chunk)
    rounded = round_steps(args.steps, chunk)
    if rounded != args.steps:
        print(f"[train_qa] Note: steps {args.steps} -> {rounded} "
              f"(multiple of --scan-chunk {chunk}; one stack shape for "
              "the whole run)", flush=True)
        args.steps = rounded
    init_state, step_fn, scan_fn = make_training(args, cfg, dev)
    params = initial_params(args, cfg, dev)
    print(f"[train_qa] model "
          f"{sum(x.numel() for x in tree_leaves(params)) / 1e6:.2f}M "
          "params", flush=True)
    state = init_state(params)
    del params

    rng = np.random.default_rng(args.seed + 7)
    extra = {"trained_on": "synth_qa", "steps": args.steps,
             "entities": args.entities, "seed": args.seed,
             "k_max": args.k_max, "seq_len": args.seq_len,
             "styled_frac": args.styled_frac, "dup_frac": args.dup_frac,
             "nbr_frac": args.nbr_frac, "answer_form": args.answer_form}
    extra["tokenizer"] = args.tokenizer
    sample_kw = sample_kwargs(args)

    def save(st, tag=""):
        if not is_writer():
            return
        save_decoder(st.params, cfg, args.out, extra=extra)
        save_world(world, os.path.join(args.out, "world.json"))
        if args.tokenizer == "word":
            tokenizer.save(args.out)
        if tag:
            print(f"[train_qa] saved checkpoint ({tag})", flush=True)

    t0 = time.time()
    sample_s = step_s = 0.0
    valid_tokens = 0
    losses: list = []
    step = 0
    while step < args.steps:
        ts = time.perf_counter()
        if scan_fn is not None:
            s = min(chunk, args.steps - step)
            stacked = sample_batch_stack(rng, tokenizer, train_pool, s,
                                         args.batch, args.seq_len,
                                         **sample_kw)
            t1 = time.perf_counter()
            valid_tokens += int(stacked["valid_len"].sum())
            state, ls = scan_fn(state, stacked)
            losses.extend(float(x) for x in ls.cpu())
            step += s
        else:
            batch = sample_batch(rng, tokenizer, train_pool, args.batch,
                                 args.seq_len, **sample_kw)
            t1 = time.perf_counter()
            valid_tokens += int(batch["valid_len"].sum())
            state, loss = step_fn(state, batch)
            losses.append(float(loss))
            step += 1
        sample_s += t1 - ts
        step_s += time.perf_counter() - t1
        prev = step - (s if scan_fn is not None else 1)
        if step // 50 != prev // 50:
            print(f"[train_qa] step {step}/{args.steps} "
                  f"loss {np.mean(losses[-50:]):.4f} "
                  f"({(time.time() - t0) / step:.2f}s/step)", flush=True)
        if (args.eval_every and
                step // args.eval_every != prev // args.eval_every) \
                or step >= args.steps:
            ev = teacher_forced_eval(state.params, cfg, tokenizer,
                                     eval_pool, eval_distract,
                                     args.seq_len, n=args.eval_n,
                                     answer_form=args.answer_form)
            print(f"[train_qa] step {step} heldout {ev}", flush=True)
            extra["final_eval"] = ev
        if args.save_every and step // args.save_every != \
                prev // args.save_every:
            save(state, tag=f"step {step}")

    save(state, tag="final")
    print(f"[train_qa] done in {time.time() - t0:.0f}s -> {args.out}",
          flush=True)
    return {"losses": losses, "final_eval": extra.get("final_eval"),
            "sample_s": sample_s, "step_s": step_s, "steps": step,
            "valid_tokens": valid_tokens,
            "padded_tokens": step * args.batch * args.seq_len,
            "state": state}


if __name__ == "__main__":
    main()
