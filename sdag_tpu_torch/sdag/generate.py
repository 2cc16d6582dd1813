"""Generation engine: SDAG prefill + causal KV-cache decode (PyTorch).

Counterpart of ``sdag_tpu/sdag/generate.py``: one block-sparse prefill per
batch (kernel K1 on CUDA), then decode with EOS early exit, batched across
queries.  Emits at most ``max_new_tokens`` tokens (the reference emits one
more; the JAX package fixed that deliberately, and the port matches the
JAX package).

Decode is the JAX package's ``while_loop`` body as a step over device
tensors only (``DecodeBuffers``): the step counter, write slot, RoPE
positions and mask are computed on the device from the counter, so the
host issues no value.  On CUDA ``DECODE_CHUNK`` such steps are captured
once per shape in a CUDA graph and replayed; the host tests "every row
done" once per chunk.  A step after every row is done writes pad and adds
no length (the JAX body's step is unconditional for the same reason), so
the chunked loop emits what the per-step loop does; a shorter graph takes
the last ``max_new % DECODE_CHUNK`` steps.  On the CPU the same step runs
eagerly.  Sampled steps invert the CDF at uniform numbers drawn from the
generator before each chunk, so a captured chunk and its eager run draw
alike.

Prompt-lookup speculative decoding (``speculative_draft`` = D > 0, the JAX
package's ``_build_speculative``) replaces the step by a round over the
same kind of state: draft D tokens by continuing the most recent
occurrence of the (prev, cur) bigram in the emitted tokens, else the
prompt; verify [cur, drafts] in one G = D + 1 token ``decode_window``;
accept the longest valid prefix (greedy: drafts equal to the argmax;
sampled: draft d accepted with probability p(d), the bonus or residual
token drawn from p without the rejected draft), each row advancing by its
own count.  Rounds are captured in chunks of ``SPEC_CHUNK`` like steps; a
round after every row is done emits nothing.  The int8 KV cache
(``kv_cache_dtype="int8"``) serves both loops.

A ``mesh`` (``core/mesh.py``, the JAX package's ``tp_mesh``) serves the
decoder Megatron-sliced over its ``model`` axis (the forwards all-reduce
and all-gather over the model group) and the batch rows split over its
``data`` axis: rows pad to the data multiple, each data rank prefills and
decodes its own rows until its own EOS, and tokens and lengths are
all-gathered.  Over NCCL the decode chunks stay captured CUDA graphs with
the collectives inside; a gloo group cannot be captured, so a mesh with
one runs the steps eagerly, chosen up front (``stats["decode_mode"]``).

While a torch.profiler collects, a call records the spans
``sdag.gen.pack`` (the prompts' masks, padding, uploads),
``sdag.gen.prefill``, ``sdag.gen.decode`` with a ``.decode.launch`` and
``.decode.wait`` per chunk, ``sdag.gen.unpack`` (download, detokenising)
and, at a shape's first use, ``sdag.gen.capture`` (``utils/profiling.py``);
the captured steps themselves hold no span.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdag_tpu_torch.models.llama import (DecoderConfig, decode_step,
                                         decode_window, local_kv_heads,
                                         make_kv_cache, prefill)
from sdag_tpu_torch.ops.sampling import (draft_accept_probs,
                                         sample_excluding, sample_tokens)
from sdag_tpu_torch.parallel.collectives import (all_gather_cat, all_reduce_,
                                                 group_backend)
from sdag_tpu_torch.parallel.sharding import (check_tp_divisible,
                                              shard_params)
from sdag_tpu_torch.sdag.mask import HOLE_DOC_ID
from sdag_tpu_torch.sdag.spans import PromptPlan
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up
from sdag_tpu_torch.utils.profiling import span

# prompts pad to this multiple (the JAX package pads to 512 on the TPU,
# where wide tiles win on grid/DMA overhead; 128 elsewhere)
PAD_MULTIPLE = 128
# decode steps between two EOS checks (one captured graph on CUDA)
DECODE_CHUNK = 8
# speculative rounds between two checks (a round emits up to D + 1 tokens)
SPEC_CHUNK = 4
# decode shapes whose buffers (and graphs) stay alive, least recent out
LIVE_SHAPES = 4


class DecodeBuffers:
    """The decode loop's state for one (batch, prompt length, max_new,
    chunk) shape, in device tensors a captured graph reads and writes in
    place: the KV cache (prefill writes the prompt's K/V into it), the step
    counter ``t`` (int64 [1]), emitted tokens, lengths, done flags, the
    current token, RoPE base positions, the prompt's slot mask, a chunk's
    uniform numbers; and on CUDA the graphs by step count.

    ``draft`` > 0 (speculation, G = draft + 1 tokens a window) adds the
    round's state: the prompt and its lengths (the draft source), the
    previous token, the rounds with a live row and the live rows summed
    over rounds, the iotas a round uses; the cache holds max_new + G slots
    past the prompt (a window writes G slots from lp + emitted), and a
    round's uniforms are [B, G] (G - 1 acceptance draws, one residual)."""

    def __init__(self, cfg: DecoderConfig, batch: int, lp: int, max_new: int,
                 chunk: int, device: torch.device, kv_dtype: str = "native",
                 draft: int = 0, n_kv_heads: Optional[int] = None) -> None:
        self.G = draft + 1 if draft else 0
        size = lp + max_new + self.G
        self.lp, self.max_new, self.chunk = lp, max_new, chunk
        self.cache = make_kv_cache(cfg, batch, size, device=device,
                                   kv_dtype=kv_dtype, n_kv_heads=n_kv_heads)
        i32 = dict(dtype=torch.int32, device=device)
        self.slot_iota = torch.arange(size, **i32)[None, :]
        self.t = torch.zeros(1, dtype=torch.int64, device=device)
        self.out = torch.zeros(batch, max_new, **i32)
        self.lengths = torch.zeros(batch, **i32)
        self.done = torch.ones(batch, dtype=torch.bool, device=device)
        self.cur = torch.zeros(batch, **i32)
        self.real_len = torch.zeros(batch, **i32)
        self.base_mask = torch.zeros(batch, size, dtype=torch.bool,
                                     device=device)
        self.uniform = torch.zeros((chunk, batch) + ((self.G,) if draft
                                                     else ()),
                                   dtype=torch.float32, device=device)
        if draft:
            self.ids = torch.zeros(batch, lp, **i32)
            self.valid_len = torch.zeros(batch, **i32)
            self.prev = torch.zeros(batch, **i32)
            self.rounds = torch.zeros(1, dtype=torch.int64, device=device)
            self.row_rounds = torch.zeros(1, dtype=torch.int64,
                                          device=device)
            self.iota_g = torch.arange(self.G, **i32)
            self.jpos = torch.arange(lp - 1, **i32)
            self.opos = torch.arange(max(max_new - 1, 0), **i32)
            self.col = torch.arange(max_new, **i32)[None, :]
        self.graphs = {}

    def step_counts(self) -> List[int]:
        """Steps of the chunks a full run replays: whole chunks, then the
        remainder."""
        return sorted({min(self.chunk, self.max_new),
                       self.max_new % self.chunk} - {0}, reverse=True)

    def start(self, cur, doc_id, valid_len, pad: int,
              input_ids=None) -> None:
        """State after prefill: nothing emitted, rows with valid_len 0
        (batch-bucket padding) born done, the prompt's visible slots (hole
        tokens of block-aligned packing stay invisible), and generated
        tokens' RoPE positions continuing the active-token count; with
        speculation the prompt ``input_ids``, its lengths and each row's
        last prompt token."""
        lp = self.lp
        visible = (self.slot_iota[:, :lp] < valid_len[:, None]) & \
            (doc_id != HOLE_DOC_ID)
        self.base_mask.zero_()
        self.base_mask[:, :lp] = visible
        self.real_len.copy_(visible.sum(1))
        self.t.zero_()
        self.out.fill_(pad)
        self.lengths.zero_()
        self.done.copy_(valid_len == 0)
        self.cur.copy_(cur)
        if self.G:
            self.ids.copy_(input_ids)
            self.valid_len.copy_(valid_len)
            last = (valid_len.long() - 1).clamp(min=0)[:, None]
            self.prev.copy_(torch.gather(input_ids, 1, last)[:, 0])
            self.rounds.zero_()
            self.row_rounds.zero_()


def _bigram_continuation(seq, match, pos, limit, cur, iota):
    """Drafts continuing the last position where ``match`` holds: the
    tokens of ``seq`` after it (``iota`` [D] offsets), each kept while it
    lies before ``limit`` and ``cur`` past it or where nothing matched.
    Returns (drafts [B, D], found [B])."""
    found = match.any(1)
    jstar = torch.where(match, pos[None, :], -1).amax(1)
    src = jstar[:, None] + 2 + iota[None, :]
    ok = found[:, None] & (src < limit[:, None])
    d = torch.gather(seq, 1, src.clamp(0, seq.shape[1] - 1).long())
    return torch.where(ok, d, cur[:, None]), found


class Generator:
    """Batched text generation with optional document isolation."""

    def __init__(self, params, cfg: DecoderConfig, tokenizer,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, batch_bucket: int = 0,
                 kv_cache_dtype: str = "native",
                 speculative_draft: int = 0, device="cuda",
                 mesh=None) -> None:
        self.device = resolve_device(device)
        if kv_cache_dtype not in ("native", "int8"):
            raise ValueError(f"Unknown kv_cache_dtype {kv_cache_dtype!r}")
        if not 0 <= int(speculative_draft) <= 15:
            raise ValueError("speculative_draft must be in [0, 15]")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        # tensor parallelism over mesh 'model', batch rows over 'data'
        self.mesh = mesh
        self.tp_group = self.dp_group = None
        self.dp_n, self.dp_rank = 1, 0
        if mesh is not None:
            check_tp_divisible(cfg, mesh.shape["model"])
            self.params = shard_params(params, cfg, mesh)
            self.tp_group = mesh.group("model")
            self.dp_group = mesh.group("data")
            self.dp_n, self.dp_rank = mesh.shape["data"], mesh.rank("data")
        self.n_kv_heads = local_kv_heads(self.params, cfg)
        self.temperature = max(float(temperature), 0.0)
        self.top_p = float(top_p)
        # partial batches pad up to this row count (0 = off); pad rows are
        # inert (valid_len 0, born done)
        self.batch_bucket = int(batch_bucket)
        self._gen = torch.Generator(device=self.device)
        # data ranks draw apart (the JAX package folds the data index into
        # its key); the model ranks of a data rank draw alike
        self._gen.manual_seed(seed + self.dp_rank)
        # 'int8': per-slot int8 K/V with f32 scales (halved KV bytes)
        self.kv_cache_dtype = kv_cache_dtype
        # prompt-lookup speculation: D drafted tokens a round (0 = off)
        self.speculative_draft = int(speculative_draft)
        # decode steps (speculative rounds) a chunk runs between EOS
        # checks (one CUDA graph)
        self.decode_chunk = SPEC_CHUNK if self.speculative_draft \
            else DECODE_CHUNK
        self._live: collections.OrderedDict = collections.OrderedDict()
        # cumulative prompt tokens / generated tokens and the host-clock
        # seconds of each phase (the device is synchronized at both ends);
        # decode steps run (chunks included whole), chunks, graph captures
        # and their seconds (warm-up step included; outside both phases)
        # a gloo group's collectives cannot be captured: its mesh decodes
        # eagerly (decided here, never by catching a failed capture)
        gloo = [a for a in ("model", "data")
                if mesh is not None and group_backend(mesh.group(a)) == "gloo"]
        self.graphs_ok = not gloo
        self.stats = {"prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_tokens": 0, "decode_s": 0.0,
                      "decode_steps": 0, "decode_chunks": 0,
                      "graph_captures": 0, "capture_s": 0.0,
                      "decode_mode": ("graphs" if self.graphs_ok else
                                      f"eager: gloo group on {gloo}")}
        # speculation, under the JAX package's names: verification rounds
        # of the last call (rounds with a live row), and cumulative rounds,
        # live rows summed over rounds, emitted tokens (tokens / row_rounds
        # - 1 = mean accepted drafts a round)
        self.last_spec_rounds = 0
        self.spec_total_rounds = 0
        self.spec_total_row_rounds = 0
        self.spec_total_tokens = 0

    @staticmethod
    def _pad_len(max_len: int) -> int:
        """Prompt length bucket (K1's 64-row tiles divide it)."""
        return _round_up(max_len, PAD_MULTIPLE)

    # ------------------------------------------------------------ public
    def generate_plans(self, plans: Sequence[PromptPlan],
                       doc_neighbors: Optional[Sequence] = None,
                       max_new_tokens: int = 128) -> List[str]:
        """ISO path: generate with document-isolation prefill."""
        ids = [p.input_ids for p in plans]
        lp = self._pad_len(max(len(x) for x in ids))
        with span("sdag.gen.pack"):
            metas = []
            for i, p in enumerate(plans):
                nbrs = doc_neighbors[i] if doc_neighbors is not None else None
                metas.append(p.metadata(doc_neighbors=nbrs, pad_to=lp))
            doc_id = np.stack([m[0] for m in metas])
            nbr_bits = np.stack([m[1] for m in metas])
            sys_user_len = np.asarray([m[2] for m in metas], np.int32)
        return self._run(ids, doc_id, nbr_bits, sys_user_len, lp,
                         max_new_tokens)

    def generate_ids(self, ids: Sequence[np.ndarray],
                     max_new_tokens: int = 128) -> List[str]:
        """NO-ISO path: plain causal generation."""
        lp = self._pad_len(max(len(x) for x in ids))
        b = len(ids)
        doc_id = np.full((b, lp), -1, np.int32)
        nbr_bits = np.zeros((b, lp), np.int32)
        sys_user_len = np.zeros((b,), np.int32)
        return self._run(ids, doc_id, nbr_bits, sys_user_len, lp,
                         max_new_tokens)

    # ----------------------------------------------------------- internal
    def _run(self, ids: Sequence[np.ndarray], doc_id, nbr_bits, sys_user_len,
             lp: int, max_new_tokens: int) -> List[str]:
        b = len(ids)
        # rows pad to the data multiple, partial batches up to the bucket
        bp = _round_up(b, self.dp_n)
        if self.batch_bucket and bp < self.batch_bucket:
            bp = _round_up(self.batch_bucket, self.dp_n)
        dev = self.device
        rows = bp // self.dp_n
        r0 = rows * self.dp_rank

        def t(a):     # this data rank's rows, on the device
            return torch.from_numpy(np.ascontiguousarray(
                a[r0:r0 + rows])).to(dev)

        with span("sdag.gen.pack"):
            batch_ids = np.full((bp, lp), self.tokenizer.pad_token_id,
                                np.int32)
            valid_len = np.zeros((bp,), np.int32)
            for i, x in enumerate(ids):
                batch_ids[i, :len(x)] = x
                valid_len[i] = len(x)
            if bp != b:
                doc_id = np.concatenate(
                    [doc_id, np.full((bp - b, lp), -1, np.int32)])
                nbr_bits = np.concatenate(
                    [nbr_bits, np.zeros((bp - b, lp), np.int32)])
                sys_user_len = np.concatenate(
                    [sys_user_len, np.zeros((bp - b,), np.int32)])
            args = [t(a) for a in (batch_ids, doc_id, nbr_bits, sys_user_len,
                                   valid_len)]
        out, lengths = self._generate(*args, max_new_tokens)
        with span("sdag.gen.unpack"):
            out, lengths = out.cpu().numpy(), lengths.cpu().numpy()
            return [self.tokenizer.decode(out[i, :lengths[i]],
                                          skip_special_tokens=True).strip()
                    for i in range(b)]

    @torch.inference_mode()
    def _generate(self, input_ids, doc_id, nbr_bits, sys_user_len,
                  valid_len, max_new: int, graphs: Optional[bool] = None):
        """Prefill, then decode until every row hit EOS or max_new tokens.
        Returns (tokens [B, max_new] int32, lengths [B]), all data ranks'
        rows under a mesh.  ``graphs``: replay captured chunks (the
        default on CUDA unless a gloo group is in the mesh; a failed
        capture raises) or run the same steps eagerly (the default on the
        CPU).  Spans ``sdag.gen.prefill`` and ``sdag.gen.decode`` cover
        what ``stats`` times as ``prefill_s`` and ``decode_s``; inside
        decode, each chunk's ``sdag.gen.decode.launch`` (enqueue the graph,
        or run the eager steps) and ``sdag.gen.decode.wait`` (the EOS
        check, which waits for the chunk; after the chunk that reaches
        max_new there is none)."""
        pad = int(self.tokenizer.pad_token_id)
        batch, lp = input_ids.shape
        if graphs is None:
            graphs = input_ids.device.type == "cuda" and self.graphs_ok
        buf = self._buffers(batch, lp, max_new, graphs)
        # read here, where the device waits for the uploads anyway
        n_in = int(valid_len.sum())
        self._sync()
        t0 = time.perf_counter()
        with span("sdag.gen.prefill"):
            logits, _ = prefill(self.params, self.cfg, input_ids,
                                doc_id=doc_id, nbr_bits=nbr_bits,
                                sys_user_len=sys_user_len,
                                valid_len=valid_len, logits_last_only=True,
                                cache=buf.cache, tp_group=self.tp_group)
            cur = sample_tokens(self._gen, logits[:, 0, :], self.temperature,
                                self.top_p)
            buf.start(cur, doc_id, valid_len, pad, input_ids=input_ids)
            self._sync()
        t1 = time.perf_counter()

        with span("sdag.gen.decode"):
            step = self._round if self.speculative_draft else self._step
            steps = 0
            finished = max_new <= 0 or bool(buf.done.all())
            while not finished:
                n = min(buf.chunk, max_new - steps)
                with span("sdag.gen.decode.launch"):
                    if self.temperature > 0.0:
                        buf.uniform.uniform_(0.0, 1.0, generator=self._gen)
                    if graphs:
                        buf.graphs[n].replay()
                    else:
                        for i in range(n):
                            step(buf, i)
                steps += n
                self.stats["decode_chunks"] += 1
                with span("sdag.gen.decode.wait"):
                    finished = steps >= max_new or bool(buf.done.all())
            out = all_gather_cat(buf.out.clone(), self.dp_group)
            lengths = all_gather_cat(buf.lengths.clone(), self.dp_group)
            n_out = int(lengths.sum())
            if self.speculative_draft:
                # data ranks stop at their own rounds: the run took the
                # most, and live rows add up
                rounds = all_reduce_(buf.rounds.clone(), self.dp_group,
                                     torch.distributed.ReduceOp.MAX)
                row_rounds = all_reduce_(buf.row_rounds.clone(),
                                         self.dp_group)
                self.last_spec_rounds = int(rounds)
                self.spec_total_rounds += self.last_spec_rounds
                self.spec_total_row_rounds += int(row_rounds)
                self.spec_total_tokens += n_out
        t2 = time.perf_counter()
        self.stats["prefill_tokens"] += n_in
        self.stats["prefill_s"] += t1 - t0
        self.stats["decode_tokens"] += n_out
        self.stats["decode_steps"] += steps
        self.stats["decode_s"] += t2 - t1
        return out, lengths

    def _step(self, buf: DecodeBuffers, i: int) -> None:
        """One decode step on ``buf`` in place, the JAX body's order:
        emit cur (pad once done), count it, mark EOS, write the step's K/V
        at slot lp + t and attend every visible slot, sample with the
        chunk's uniform row i, advance t."""
        eos = int(self.tokenizer.eos_token_id)
        pad = int(self.tokenizer.pad_token_id)
        lp, cur, done, t = buf.lp, buf.cur, buf.done, buf.t
        buf.out.index_copy_(1, t, torch.where(done, pad, cur)[:, None])
        buf.lengths += (~done).to(torch.int32)
        done |= cur == eos
        slot = t + lp
        mask = buf.base_mask | ((buf.slot_iota >= lp)
                                & (buf.slot_iota <= slot))
        logits, _ = decode_step(self.params, self.cfg, cur,
                                buf.real_len + t, buf.cache,
                                write_index=slot, cache_mask=mask,
                                tp_group=self.tp_group)
        nxt = sample_tokens(None, logits, self.temperature, self.top_p,
                            uniform=buf.uniform[i])
        cur.copy_(torch.where(done, eos, nxt))
        t += 1

    def _round(self, buf: DecodeBuffers, i: int) -> None:
        """One speculative round on ``buf`` in place, the JAX body's order
        (``_build_speculative``): count the round and its live rows; draft
        by bigram lookup (emitted tokens first, then the prompt); verify
        [cur, drafts] in one window; accept the longest valid prefix, cut
        at EOS and the budget (nothing for a done row); emit; the next cur
        is the argmax (greedy) or the bonus / residual draw at the chunk's
        uniforms of row i."""
        eos = int(self.tokenizer.eos_token_id)
        G, lp, max_new = buf.G, buf.lp, buf.max_new
        cur, prev, n, done, out = buf.cur, buf.prev, buf.lengths, buf.done, \
            buf.out
        iota_g, slot_iota = buf.iota_g, buf.slot_iota
        live = ~done
        buf.rounds += live.any().long()
        buf.row_rounds += live.sum()
        # ---- draft: continue the last (prev, cur) bigram
        ids, vl = buf.ids, buf.valid_len
        m = (ids[:, :-1] == prev[:, None]) & (ids[:, 1:] == cur[:, None]) \
            & ((buf.jpos + 1)[None, :] < vl[:, None])
        drafts, _ = _bigram_continuation(ids, m, buf.jpos, vl, cur,
                                         iota_g[:G - 1])
        if max_new > 1:
            mo = (out[:, :-1] == prev[:, None]) & \
                (out[:, 1:] == cur[:, None]) & \
                ((buf.opos + 1)[None, :] < n[:, None])
            drafts_o, found_o = _bigram_continuation(out, mo, buf.opos, n,
                                                     cur, iota_g[:G - 1])
            drafts = torch.where(found_o[:, None], drafts_o, drafts)
        w = torch.cat([cur[:, None], drafts], dim=1)               # [B, G]
        # ---- verify in one G-token forward
        # the window attends the slots a plain decode's cache has (lp +
        # max_new): a window row past them (past the token budget) is
        # never emitted, and the other rows see what a decode step sees
        pos = (buf.real_len + n)[:, None] + iota_g[None, :]
        base = lp + n
        att = slot_iota[:, :lp + max_new]
        hist = buf.base_mask[:, :lp + max_new] | ((att >= lp)
                                                  & (att < base[:, None]))
        win = (att[:, None, :] >= base[:, None, None]) & \
            (att[:, None, :] <= base[:, None, None] + iota_g[None, :, None])
        logits, _ = decode_window(self.params, self.cfg, w, pos, buf.cache,
                                  base, hist[:, None, :] | win,
                                  tp_group=self.tp_group)
        # ---- accept the longest valid draft prefix (+ EOS / budget)
        if self.temperature == 0.0:
            g_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            match = (w[:, 1:] == g_tok[:, :-1]).to(torch.int32)
        else:
            p_acc = draft_accept_probs(logits[:, :-1], w[:, 1:],
                                       self.temperature, self.top_p)
            match = (buf.uniform[i, :, :G - 1] < p_acc).to(torch.int32)
        a = torch.cumprod(match, dim=1).sum(1).to(torch.int32)
        eos_pos = torch.where(w == eos, iota_g[None, :], G).amin(1)
        emit = torch.minimum(torch.minimum(1 + a, eos_pos + 1), max_new - n)
        emit = torch.where(done, 0, emit)
        rel = buf.col - n[:, None]
        in_row = (rel >= 0) & (rel < emit[:, None])
        vals = torch.gather(w, 1, rel.clamp(0, G - 1).long())
        out.copy_(torch.where(in_row, vals, out))
        n += emit
        done |= (eos_pos < emit) | (n >= max_new)
        last_idx = (emit - 1).clamp(min=0)[:, None].long()
        prev.copy_(torch.where(emit > 0, torch.gather(w, 1, last_idx)[:, 0],
                               prev))
        if self.temperature == 0.0:
            nxt = torch.gather(g_tok, 1, last_idx)[:, 0]
        else:
            # bonus / residual draw at the last verified position; the
            # rejected draft is excluded iff a rejection cut the chain
            logits_last = torch.gather(
                logits, 1, last_idx[:, :, None].expand(-1, 1,
                                                       logits.shape[-1]))
            cut = (emit == 1 + a) & (a < G - 1) & ~done
            rej = torch.gather(w, 1, emit.clamp(0, G - 1)[:, None].long())
            excl = torch.where(cut, rej[:, 0], -1)
            nxt = sample_excluding(buf.uniform[i, :, G - 1],
                                   logits_last[:, 0], excl,
                                   self.temperature, self.top_p)
        cur.copy_(torch.where(done, eos, nxt))

    def _buffers(self, batch: int, lp: int, max_new: int,
                 graphs: bool) -> DecodeBuffers:
        """The shape's buffers, made (and on CUDA captured) at first use;
        at most ``LIVE_SHAPES`` shapes stay alive."""
        key = (batch, lp, max_new, self.decode_chunk)
        buf = self._live.pop(key, None)
        if buf is None:
            while len(self._live) >= LIVE_SHAPES:
                self._live.popitem(last=False)
            buf = DecodeBuffers(self.cfg, batch, lp, max_new,
                                self.decode_chunk, self.device,
                                kv_dtype=self.kv_cache_dtype,
                                draft=self.speculative_draft,
                                n_kv_heads=self.n_kv_heads)
        self._live[key] = buf
        if graphs and not buf.graphs:
            with span("sdag.gen.capture"):
                self._capture(buf)
        return buf

    def _capture(self, buf: DecodeBuffers) -> None:
        """One graph per chunk length of ``buf.step_counts()``, sharing a
        memory pool.  One step (round) runs eagerly first, on a side
        stream, so lazy set-up (cuBLAS, the RoPE frequencies) stays out of
        the capture; it runs on state ``start`` overwrites before
        decoding."""
        dev = self.device
        step = self._round if self.speculative_draft else self._step
        t0 = time.perf_counter()
        buf.t.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(buf, 0)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for n in buf.step_counts():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                for i in range(n):
                    step(buf, i)
            buf.graphs[n] = graph
            self.stats["graph_captures"] += 1
        self._sync()
        self.stats["capture_s"] += time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
