"""Plain float32 reference of a sparse-expert decoder with windowed and
full attention layers (Mellum2-12B-A2.5B's equations).

h = x + Wo . Attn(RMSNorm(x)); out = h + sum over the top k experts e of
w_e . down_e(SiLU(gate_e u) * up_e u), u = RMSNorm(h), w = softmax(u .
W_router) in float32 over all experts, its top k divided by their sum
(``norm_topk_prob``).  Each layer's kind (``layer_types``) picks its RoPE
from ``rope_parameters`` ("default", or "yarn" as HF's
``_compute_yarn_parameters`` writes it: the extrapolated frequencies and
those over ``factor`` blended by a linear ramp between the correction dims
of beta_fast and beta_slow, cos and sin times the attention factor) and,
for "sliding_attention", a window: key j is visible from row i only when
i - j < sliding_window as well (HF's convention: a row's own key is one of
its window's).  The mask is ``llama_decoder.mask_for``'s: the SDAG rule
for an ISO prompt, plain causal for a NO-ISO one, every served token
causal.  Each token's expert sum is taken over the experts it picked, one
expert at a time, the tokens that picked it gathered (the same sum as a
dense one over all experts weighted 0 where not picked).

It reads the weights the benchmark made (the port's tree: ``x @ w``
matrices, experts [E, out, in]) and upcasts them a layer at a time, the
experts eight at a time, so the model never exists in float32.  Matrix
products run in float32 with TF32 off.  Given the experts the program
routed each position to, it takes those in place of its own top k
(``served_gaps``).  It imports nothing of the program.  Departures from the published model: no MTP head (plain serving
does not run one), random weights.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference.llama_decoder import Seq, mask_for

EXPERT_BLOCK = 8


def inv_freqs(rope: Dict[str, Any], head_dim: int, device
              ) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies [head_dim / 2] float64, attention factor)."""
    base = float(rope["rope_theta"])
    dim = head_dim
    extrap = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                         device=device) / dim)
    if rope["rope_type"] == "default":
        return extrap, 1.0
    factor = float(rope["factor"])
    orig = float(rope["original_max_position_embeddings"])

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(corr(float(rope["beta_fast"]))), 0)
    high = min(math.ceil(corr(float(rope["beta_slow"]))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    return extrap / factor * ramp + extrap * (1 - ramp), \
        float(rope["attention_factor"])


def _rope(x: torch.Tensor, inv: torch.Tensor, mscale: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    ang = torch.arange(x.shape[1], dtype=torch.float64,
                       device=x.device)[:, None] * inv
    cos, sin = (ang.cos() * mscale).float(), (ang.sin() * mscale).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def served_gaps(params: Dict[str, Any], cfg: Dict[str, Any],
                seqs: Sequence[Seq], device,
                routes: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[List[List[float]], List[torch.Tensor]]:
    """For each sequence, the gap (best logit minus the served token's
    logit) at every served position, by the float32 forward over prompt +
    served tokens; and the router's shortfall at every position (float64
    [layers, positions]): its k-th largest logit less the smallest logit
    among the experts taken, 0 where it took its own top k.  ``routes``:
    per sequence, the experts the program picked at each position (int64
    [layers, positions, k], -1 where it logged none); the forward then
    takes those, weighted by its own softmax over all experts renormalised
    over them, in place of its own top k, so the gap reads rounding alone
    and the shortfall how far the program's picks fall below the top k.
    ``cfg``: the published config's keys."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_gaps(params, cfg, seqs, device, routes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _attention(x, a, ln1, eps, mask, inv, mscale, hq, hkv, hd):
    s = x.shape[0]
    h = _rms(x, ln1, eps)
    q = (h @ a["wq"]).view(s, hq, hd).transpose(0, 1)
    k = (h @ a["wk"]).view(s, hkv, hd).transpose(0, 1)
    v = (h @ a["wv"]).view(s, hkv, hd).transpose(0, 1)
    q, k = _rope(q, inv, mscale), _rope(k, inv, mscale)
    k = k.repeat_interleave(hq // hkv, 0)
    v = v.repeat_interleave(hq // hkv, 0)
    sc = (q @ k.transpose(1, 2)) / math.sqrt(hd)
    sc = sc.masked_fill(~mask[None], float("-inf"))
    o = torch.softmax(sc, -1) @ v
    return x + o.transpose(0, 1).reshape(s, hq * hd) @ a["wo"]


@torch.no_grad()
def _served_gaps(params, cfg, seqs, device, forced):
    hq = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    hd = int(cfg["head_dim"])
    eps = float(cfg["rms_norm_eps"])
    k_top = int(cfg["num_experts_per_tok"])
    window = int(cfg["sliding_window"])
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    emb = params["embed"]
    xs = [f32(emb[torch.as_tensor(s.ids, device=emb.device).long()])
          for s in seqs]
    masks = [mask_for(s, device) for s in seqs]
    short: List[List[torch.Tensor]] = [[] for _ in seqs]
    for li, layer in enumerate(params["layers"]):
        kind = cfg["layer_types"][li]
        inv, mscale = inv_freqs(cfg["rope_parameters"][kind], hd, device)
        a = {k: f32(v) for k, v in layer["attn"].items()}
        ln1, ln2 = f32(layer["ln1"]), f32(layer["ln2"])
        router = f32(layer["moe"]["router"])
        us, picks = [], []
        for n, x in enumerate(xs):
            mask = masks[n]
            if kind == "sliding_attention":
                i = torch.arange(x.shape[0], device=device)
                mask = mask & (i[:, None] - i[None, :] < window)
            x = xs[n] = _attention(x, a, ln1, eps, mask, inv, mscale, hq,
                                   hkv, hd)
            u = _rms(x, ln2, eps)
            logits = u @ router
            probs = torch.softmax(logits, -1)
            top_w, top_i = torch.topk(probs, k_top, dim=-1)
            if forced is not None:
                want = forced[n][li].to(device)
                take = (want >= 0).all(-1, keepdim=True)
                top_i = torch.where(take, want, top_i)
                top_w = probs.gather(1, top_i)
                kth = torch.topk(logits, k_top, dim=-1).values[:, -1]
                low = logits.gather(1, top_i).min(-1).values
                short[n].append((kth - low).clamp_min(0).double())
            else:
                short[n].append(torch.zeros(x.shape[0], dtype=torch.float64,
                                            device=device))
            if cfg["norm_topk_prob"]:
                top_w = top_w / top_w.sum(-1, keepdim=True)
            us.append(u)
            picks.append((top_w, top_i))
        del a
        gate_up, down = layer["moe"]["gate_up"], layer["moe"]["down"]
        f = down.shape[2]
        for e0 in range(0, gate_up.shape[0], EXPERT_BLOCK):
            gu_blk = f32(gate_up[e0:e0 + EXPERT_BLOCK])
            dn_blk = f32(down[e0:e0 + EXPERT_BLOCK])
            for n, u in enumerate(us):
                top_w, top_i = picks[n]
                for b in range(gu_blk.shape[0]):
                    hit = top_i == e0 + b
                    rows = hit.any(-1).nonzero()[:, 0]
                    if rows.numel() == 0:
                        continue
                    ur = u[rows]
                    y = (torch.nn.functional.silu(ur @ gu_blk[b, :f].T)
                         * (ur @ gu_blk[b, f:].T)) @ dn_blk[b].T
                    w = (top_w * hit).sum(-1)[rows]
                    xs[n][rows] = xs[n][rows] + w[:, None] * y
            del gu_blk, dn_blk
    fn = f32(params["final_norm"])
    head = f32(params["lm_head"])
    out = []
    for s, x in zip(seqs, xs):
        t = len(s.ids) - s.prompt_len
        rows = _rms(x[s.prompt_len - 1: s.prompt_len - 1 + t], fn, eps)
        logits = rows @ head
        served = torch.as_tensor(s.ids[s.prompt_len:], device=device).long()
        gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
        out.append(gap.double().cpu().tolist())
    return out, [torch.stack(r) for r in short]
