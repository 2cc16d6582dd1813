"""Plain float32 reference of a sparse-expert decoder with windowed and
full attention layers (Mellum2-12B-A2.5B's equations), for the CPU tests.

h = x + Wo . Attn(RMSNorm(x)); out = h + sum over the top k experts e of
w_e . down_e(SiLU(gate_e u) * up_e u), u = RMSNorm(h), w = softmax(u .
W_router) over all experts, its top k divided by their sum.  Each layer's
kind (``layer_types``) picks its RoPE from ``rope_parameters`` ("default"
or "yarn", written from HF's ``_compute_yarn_parameters``: cos and sin
times the attention factor) and, for "sliding_attention", a window: key j
is visible from row i only when i - j < sliding_window as well.  The mask
is the SDAG rule for an ISO prompt (a passage row sees the system/user
prefix and its own passage causally; other rows causal), plain causal
without passages.  Expert sums are dense: every expert of every token,
weighted by zero where it was not picked.

``cfg`` holds the published config's keys; the weights are the port's
tree (``x @ w`` matrices, experts [E, out, in]).  Departures from the
published model: no MTP head, random weights.  It imports nothing of the
program and sets TF32 off.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch


def sdag_mask(n: int, sys_user_len: int = 0,
              doc_spans: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """[n, n] bool, True where row i may attend key j."""
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    mask = j <= i
    for a, b in doc_spans:
        mask[a:b] = (j < sys_user_len) | ((j >= a) & (j <= i[a:b]))
    return mask


def inv_freqs(rope: Dict[str, Any], head_dim: int) -> Tuple[torch.Tensor,
                                                             float]:
    """(inverse frequencies [head_dim / 2] float64, attention factor)."""
    base = float(rope["rope_theta"])
    dim = head_dim
    extrap = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                            / dim)
    if rope["rope_type"] == "default":
        return extrap, 1.0
    factor = float(rope["factor"])
    orig = float(rope["original_max_position_embeddings"])

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    low = max(math.floor(corr(float(rope["beta_fast"]))), 0)
    high = min(math.ceil(corr(float(rope["beta_slow"]))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv = extrap / factor * ramp + extrap * (1 - ramp)
    return inv, float(rope["attention_factor"])


def _rope(x: torch.Tensor, inv: torch.Tensor, mscale: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    ang = torch.arange(x.shape[1], dtype=torch.float64)[:, None] * inv
    cos, sin = (ang.cos() * mscale).float(), (ang.sin() * mscale).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def forward(params: Dict[str, Any], cfg: Dict[str, Any], ids: Sequence[int],
            sys_user_len: int = 0,
            doc_spans: Sequence[Tuple[int, int]] = ()) -> torch.Tensor:
    """Logits [len(ids), vocab] of one sequence, float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(params, cfg, ids, sys_user_len, doc_spans)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _forward(params, cfg, ids, sys_user_len, doc_spans):
    hq = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    hd = int(cfg["head_dim"])
    eps = float(cfg["rms_norm_eps"])
    k_top = int(cfg["num_experts_per_tok"])
    n = len(ids)
    base_mask = sdag_mask(n, sys_user_len, doc_spans)
    i = torch.arange(n)[:, None]
    j = torch.arange(n)[None, :]
    x = params["embed"].float()[torch.as_tensor(ids).long()]
    for li, layer in enumerate(params["layers"]):
        kind = cfg["layer_types"][li]
        mask = base_mask & (i - j < int(cfg["sliding_window"])) \
            if kind == "sliding_attention" else base_mask
        inv, mscale = inv_freqs(cfg["rope_parameters"][kind], hd)
        a = {k: v.float() for k, v in layer["attn"].items()}
        h = _rms(x, layer["ln1"], eps)
        q = (h @ a["wq"]).view(n, hq, hd).transpose(0, 1)
        k = (h @ a["wk"]).view(n, hkv, hd).transpose(0, 1)
        v = (h @ a["wv"]).view(n, hkv, hd).transpose(0, 1)
        q, k = _rope(q, inv, mscale), _rope(k, inv, mscale)
        k = k.repeat_interleave(hq // hkv, 0)
        v = v.repeat_interleave(hq // hkv, 0)
        sc = (q @ k.transpose(1, 2)) / math.sqrt(hd)
        sc = sc.masked_fill(~mask[None], float("-inf"))
        o = torch.softmax(sc, -1) @ v
        x = x + o.transpose(0, 1).reshape(n, hq * hd) @ a["wo"]
        u = _rms(x, layer["ln2"], eps)
        m = {k: v.float() for k, v in layer["moe"].items()}
        probs = torch.softmax(u @ m["router"], -1)
        top_w, top_i = torch.topk(probs, k_top, dim=-1)
        if cfg["norm_topk_prob"]:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        dense_w = torch.zeros_like(probs).scatter_(1, top_i, top_w)
        f = m["down"].shape[2]
        out = torch.zeros_like(x)
        for e in range(m["router"].shape[1]):
            g = u @ m["gate_up"][e, :f].T
            up = u @ m["gate_up"][e, f:].T
            y = (torch.nn.functional.silu(g) * up) @ m["down"][e].T
            out += dense_w[:, e:e + 1] * y
        x = x + out
    x = _rms(x, params["final_norm"], eps)
    return x @ params["lm_head"].float()
