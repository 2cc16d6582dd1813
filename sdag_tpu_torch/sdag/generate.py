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
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdag_tpu_torch.models.llama import (DecoderConfig, decode_step,
                                         make_kv_cache, prefill)
from sdag_tpu_torch.ops.sampling import sample_tokens
from sdag_tpu_torch.sdag.mask import HOLE_DOC_ID
from sdag_tpu_torch.sdag.spans import PromptPlan
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up

# prompts pad to this multiple (the JAX package pads to 512 on the TPU,
# where wide tiles win on grid/DMA overhead; 128 elsewhere)
PAD_MULTIPLE = 128
# decode steps between two EOS checks (one captured graph on CUDA)
DECODE_CHUNK = 8
# decode shapes whose buffers (and graphs) stay alive, least recent out
LIVE_SHAPES = 4


class DecodeBuffers:
    """The decode loop's state for one (batch, prompt length, max_new,
    chunk) shape, in device tensors a captured graph reads and writes in
    place: the KV cache (prefill writes the prompt's K/V into it), the step
    counter ``t`` (int64 [1]), emitted tokens, lengths, done flags, the
    current token, RoPE base positions, the prompt's slot mask, a chunk's
    uniform numbers; and on CUDA the graphs by step count."""

    def __init__(self, cfg: DecoderConfig, batch: int, lp: int, max_new: int,
                 chunk: int, device: torch.device) -> None:
        size = lp + max_new
        self.lp, self.max_new, self.chunk = lp, max_new, chunk
        self.cache = make_kv_cache(cfg, batch, size, device=device)
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
        self.uniform = torch.zeros(chunk, batch, dtype=torch.float32,
                                   device=device)
        self.graphs = {}

    def step_counts(self) -> List[int]:
        """Steps of the chunks a full run replays: whole chunks, then the
        remainder."""
        return sorted({min(self.chunk, self.max_new),
                       self.max_new % self.chunk} - {0}, reverse=True)

    def start(self, cur, doc_id, valid_len, pad: int) -> None:
        """State after prefill: nothing emitted, rows with valid_len 0
        (batch-bucket padding) born done, the prompt's visible slots (hole
        tokens of block-aligned packing stay invisible), and generated
        tokens' RoPE positions continuing the active-token count."""
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


class Generator:
    """Batched text generation with optional document isolation."""

    def __init__(self, params, cfg: DecoderConfig, tokenizer,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, batch_bucket: int = 0,
                 device="cuda") -> None:
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.temperature = max(float(temperature), 0.0)
        self.top_p = float(top_p)
        # partial batches pad up to this row count (0 = off); pad rows are
        # inert (valid_len 0, born done)
        self.batch_bucket = int(batch_bucket)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # decode steps a chunk runs between EOS checks (one CUDA graph)
        self.decode_chunk = DECODE_CHUNK
        self._live: collections.OrderedDict = collections.OrderedDict()
        # cumulative prompt tokens / generated tokens and the host-clock
        # seconds of each phase (the device is synchronized at both ends);
        # decode steps run (chunks included whole), chunks, graph captures
        # and their seconds (warm-up step included; outside both phases)
        self.stats = {"prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_tokens": 0, "decode_s": 0.0,
                      "decode_steps": 0, "decode_chunks": 0,
                      "graph_captures": 0, "capture_s": 0.0}

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
        bp = max(b, self.batch_bucket)
        batch_ids = np.full((bp, lp), self.tokenizer.pad_token_id, np.int32)
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
        dev = self.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
        out, lengths = self._generate(t(batch_ids), t(doc_id), t(nbr_bits),
                                      t(sys_user_len), t(valid_len),
                                      max_new_tokens)
        out, lengths = out.cpu().numpy(), lengths.cpu().numpy()
        return [self.tokenizer.decode(out[i, :lengths[i]],
                                      skip_special_tokens=True).strip()
                for i in range(b)]

    @torch.inference_mode()
    def _generate(self, input_ids, doc_id, nbr_bits, sys_user_len,
                  valid_len, max_new: int, graphs: Optional[bool] = None):
        """Prefill, then decode until every row hit EOS or max_new tokens.
        Returns (tokens [B, max_new] int32, lengths [B]).  ``graphs``:
        replay captured chunks (the default on CUDA; a failed capture
        raises) or run the same steps eagerly (the default on the CPU)."""
        pad = int(self.tokenizer.pad_token_id)
        batch, lp = input_ids.shape
        if graphs is None:
            graphs = input_ids.device.type == "cuda"
        buf = self._buffers(batch, lp, max_new, graphs)
        self._sync()
        t0 = time.perf_counter()
        logits, _ = prefill(self.params, self.cfg, input_ids, doc_id=doc_id,
                            nbr_bits=nbr_bits, sys_user_len=sys_user_len,
                            valid_len=valid_len, logits_last_only=True,
                            cache=buf.cache)
        cur = sample_tokens(self._gen, logits[:, 0, :], self.temperature,
                            self.top_p)
        buf.start(cur, doc_id, valid_len, pad)
        self._sync()
        t1 = time.perf_counter()

        steps = 0
        while steps < max_new and not bool(buf.done.all()):
            n = min(buf.chunk, max_new - steps)
            if self.temperature > 0.0:
                buf.uniform.uniform_(0.0, 1.0, generator=self._gen)
            if graphs:
                buf.graphs[n].replay()
            else:
                for i in range(n):
                    self._step(buf, i)
            steps += n
            self.stats["decode_chunks"] += 1
        out, lengths = buf.out.clone(), buf.lengths.clone()
        n_out = int(lengths.sum())
        t2 = time.perf_counter()
        self.stats["prefill_tokens"] += int(valid_len.sum())
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
                                write_index=slot, cache_mask=mask)
        nxt = sample_tokens(None, logits, self.temperature, self.top_p,
                            uniform=buf.uniform[i])
        cur.copy_(torch.where(done, eos, nxt))
        t += 1

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
                                self.decode_chunk, self.device)
        self._live[key] = buf
        if graphs and not buf.graphs:
            self._capture(buf)
        return buf

    def _capture(self, buf: DecodeBuffers) -> None:
        """One graph per chunk length of ``buf.step_counts()``, sharing a
        memory pool.  One step runs eagerly first, on a side stream, so
        lazy set-up (cuBLAS, the RoPE frequencies) stays out of the
        capture; it runs on state ``start`` overwrites before decoding."""
        dev = self.device
        t0 = time.perf_counter()
        buf.t.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step(buf, 0)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for n in buf.step_counts():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                for i in range(n):
                    self._step(buf, i)
            buf.graphs[n] = graph
            self.stats["graph_captures"] += 1
        self._sync()
        self.stats["capture_s"] += time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
