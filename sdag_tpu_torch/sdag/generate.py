"""Generation engine: SDAG prefill + causal KV-cache decode (PyTorch).

Counterpart of ``sdag_tpu/sdag/generate.py``: one block-sparse prefill per
batch (kernel K1 on CUDA), then a Python decode loop with EOS early exit,
batched across queries.  Emits at most ``max_new_tokens`` tokens (the
reference emits one more; the JAX package fixed that deliberately, and the
port matches the JAX package).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdag_tpu_torch.models.llama import DecoderConfig, decode_step, prefill
from sdag_tpu_torch.ops.sampling import sample_tokens
from sdag_tpu_torch.sdag.spans import PromptPlan
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up

# prompts pad to this multiple (the JAX package pads to 512 on the TPU,
# where wide tiles win on grid/DMA overhead; 128 elsewhere)
PAD_MULTIPLE = 128


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
        # cumulative prompt tokens / generated tokens and the host-clock
        # seconds of each phase (the device is synchronized at both ends)
        self.stats = {"prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_tokens": 0, "decode_s": 0.0}

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
                  valid_len, max_new: int):
        """Prefill, then decode until every row hit EOS or max_new tokens.
        Returns (tokens [B, max_new] int32, lengths [B])."""
        cfg = self.cfg
        eos = int(self.tokenizer.eos_token_id)
        pad = int(self.tokenizer.pad_token_id)
        batch, lp = input_ids.shape
        dev = input_ids.device
        cache_size = lp + max_new
        self._sync()
        t0 = time.perf_counter()
        logits, cache = prefill(self.params, cfg, input_ids, doc_id=doc_id,
                                nbr_bits=nbr_bits, sys_user_len=sys_user_len,
                                valid_len=valid_len, cache_size=cache_size,
                                logits_last_only=True)
        cur = sample_tokens(self._gen, logits[:, 0, :], self.temperature,
                            self.top_p)
        self._sync()
        t1 = time.perf_counter()

        slot_iota = torch.arange(cache_size, dtype=torch.int32,
                                 device=dev)[None, :]
        # hole tokens (block-aligned packing) are invisible in decode too
        active = torch.cat([doc_id != -2,
                            torch.ones(batch, max_new, dtype=torch.bool,
                                       device=dev)], dim=1)
        base_mask = (slot_iota < valid_len[:, None]) & active
        # generated tokens' RoPE positions continue the active-token count
        real_len = ((doc_id != -2) & (slot_iota[:, :lp] < valid_len[:, None])
                    ).sum(1).to(torch.int32)

        out = torch.full((batch, max_new), pad, dtype=torch.int32,
                         device=dev)
        # rows padded for batch bucketing carry valid_len == 0: born done
        done = valid_len == 0
        lengths = torch.zeros(batch, dtype=torch.int32, device=dev)
        steps = 0
        while steps < max_new and not bool(done.all()):
            out[:, steps] = torch.where(done, pad, cur)
            lengths += (~done).to(torch.int32)
            done = done | (cur == eos)
            mask = base_mask | ((slot_iota >= lp) & (slot_iota <= lp + steps))
            logits, cache = decode_step(self.params, cfg, cur,
                                        real_len + steps, cache,
                                        write_index=lp + steps,
                                        cache_mask=mask)
            nxt = sample_tokens(self._gen, logits, self.temperature,
                                self.top_p)
            cur = torch.where(done, eos, nxt)
            steps += 1
        n_out = int(lengths.sum())
        t2 = time.perf_counter()
        self.stats["prefill_tokens"] += int(valid_len.sum())
        self.stats["prefill_s"] += t1 - t0
        self.stats["decode_tokens"] += n_out
        self.stats["decode_s"] += t2 - t1
        return out, lengths

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
