"""Token sampling: temperature + nucleus (top-p), on explicit generators.

Counterpart of ``sdag_tpu/ops/sampling.py``: temperature 0 means greedy
argmax (first maximum on ties, as jnp.argmax), otherwise softmax sampling
after top-p truncation.  A draw inverts the categorical CDF at one uniform
number per row, taken from a ``torch.Generator`` or handed in (a decode
step captured in a CUDA graph reads uniforms drawn outside it); draws
follow the same distribution as the JAX sampler, not the same bits.
Speculative sampling's pair (``draft_accept_probs``, ``sample_excluding``)
takes its uniforms the same way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus: keep the smallest set of tokens whose
    cumulative probability reaches top_p.  logits: [..., V].  Exact
    (full-sort) variant; ``sample_tokens`` uses the top-k-bounded one."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token ranked r is kept iff cumulative prob *before* it is < top_p
    keep_sorted = (cum - probs) < top_p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full_like(sorted_logits, float("inf"))
                            ).amin(-1, keepdim=True)
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, float("-inf")))


def _ordered_topk(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k values descending, ties to the lower index (lax.top_k's
    order; torch.topk does not promise one)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nucleus_vals_idx(logits: torch.Tensor, top_p: float, nucleus_topk: int,
                      presorted=None):
    """Bounded-nucleus candidate set: (vals, idx) of the top-k logits with
    outside-nucleus entries masked to -inf; the CDF uses the FULL-vocab
    partition function."""
    if presorted is not None:
        vals, idx = presorted
    else:
        vals, idx = _ordered_topk(logits, min(nucleus_topk,
                                              logits.shape[-1]))
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(vals - logz)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p                   # rank 0 always kept
    return torch.where(keep, vals, torch.full_like(vals, float("-inf"))), idx


def _categorical(uniform: torch.Tensor, logits: torch.Tensor
                 ) -> torch.Tensor:
    """One draw per row of [..., V] unnormalized log-probabilities: the
    first column whose cumulative probability exceeds the row's uniform
    number in [0, 1) (zero-probability columns are never taken)."""
    flat = logits.reshape(-1, logits.shape[-1])
    cdf = torch.cumsum(torch.softmax(flat.float(), dim=-1), dim=-1)
    target = uniform.reshape(-1, 1).to(cdf.dtype) * cdf[:, -1:]
    draw = torch.searchsorted(cdf, target, right=True)[:, 0]
    return draw.clamp(max=flat.shape[-1] - 1).reshape(logits.shape[:-1])


def sample_tokens(generator: Optional[torch.Generator],
                  logits: torch.Tensor, temperature: float = 0.0,
                  top_p: float = 1.0, nucleus_topk: int = 64,
                  uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample next tokens from [..., V] logits.  temperature <= 0 -> greedy.

    top_p < 1 ranks only the ``nucleus_topk`` highest logits (identical to
    the exact filter whenever the nucleus fits in them).  ``uniform``:
    one number in [0, 1) per row (drawn from ``generator`` when None)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if uniform is None:
        uniform = torch.rand(logits.shape[:-1], generator=generator,
                             device=logits.device)
    logits = logits / temperature
    if top_p >= 1.0:
        return _categorical(uniform, logits).to(torch.int32)
    kk = min(nucleus_topk, logits.shape[-1])
    vals, idx = _nucleus_vals_idx(logits, top_p, kk,
                                  presorted=_ordered_topk(logits, kk))
    choice = _categorical(uniform, vals)
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


def draft_accept_probs(logits: torch.Tensor, drafts: torch.Tensor,
                       temperature: float, top_p: float = 1.0,
                       nucleus_topk: int = 64) -> torch.Tensor:
    """P(draft token) under ``sample_tokens``' distribution, per position.

    logits [..., V]; drafts [...] token ids.  Speculative sampling accepts
    a deterministic (prob-1) draft with probability p(draft), which keeps
    the output distribution that of ``sample_tokens`` step by step.  With
    top_p < 1 the probability is renormalised over the bounded nucleus; a
    draft outside it has probability 0."""
    logits = logits / temperature
    drafts = drafts.long()[..., None]
    if top_p >= 1.0:
        logz = torch.logsumexp(logits, dim=-1)
        return torch.exp(torch.gather(logits, -1, drafts)[..., 0] - logz)
    kk = min(nucleus_topk, logits.shape[-1])
    vals, idx = _nucleus_vals_idx(logits, top_p, kk)
    logz = torch.logsumexp(vals, dim=-1)
    hit = torch.where(idx == drafts, vals, torch.full_like(vals,
                                                           float("-inf")))
    return torch.exp(hit.amax(-1) - logz)


def sample_excluding(uniform: torch.Tensor, logits: torch.Tensor,
                     excl: torch.Tensor, temperature: float,
                     top_p: float = 1.0,
                     nucleus_topk: int = 64) -> torch.Tensor:
    """Draw like ``sample_tokens`` with token ``excl[b]`` removed (excl ==
    -1 keeps every token of that row): the residual draw of speculative
    sampling with a prob-1 draft, where max(p - delta_d, 0) renormalised
    is p restricted to x != d.  logits [B, V]; uniform [B] in [0, 1): the
    CDF of the renormalised distribution is inverted there."""
    logits = logits / temperature
    excl = excl.long()[:, None]
    ninf = float("-inf")
    if top_p >= 1.0:
        col = torch.arange(logits.shape[-1], device=logits.device)
        masked = logits.masked_fill(col[None, :] == excl, ninf)
        return _categorical(uniform, masked).to(torch.int32)
    kk = min(nucleus_topk, logits.shape[-1])
    vals, idx = _nucleus_vals_idx(logits, top_p, kk)
    vals = vals.masked_fill(idx == excl, ninf)
    choice = _categorical(uniform, vals)
    return torch.gather(idx, -1, choice[:, None])[:, 0].to(torch.int32)
