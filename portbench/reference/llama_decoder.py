"""Plain float32 reference of a Llama-family decoder (Mistral-7B-v0.3's
equations): RMSNorm, RoPE (rotate-half, no frequency scaling), grouped-query
attention, SwiGLU MLP, untied head, no biases.

It reads the weights the benchmark made (each [in, out], ``x @ w``) and
upcasts them layer by layer, so the whole model never exists in float32.
Sequences are the prompt followed by the served tokens; the mask is the
SDAG rule for an ISO prompt (a passage row sees the system/user prefix and
its own passage causally; every other row, and every served token, is
causal) and plain causal for a NO-ISO prompt.  Matrix products run in
float32 with TF32 off.  It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch


@dataclass
class Seq:
    """One request: its prompt followed by its served tokens, and the
    prompt's SDAG layout (no passage spans: a causal prompt)."""
    ids: List[int]
    prompt_len: int
    sys_user_len: int = 0
    doc_spans: Tuple[Tuple[int, int], ...] = ()


def mask_for(seq: Seq, device) -> torch.Tensor:
    """[S, S] bool, True where row i may attend key j."""
    s = len(seq.ids)
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    mask = j <= i
    for a, b in seq.doc_spans:
        rows = i[a:b]
        mask[a:b] = (j < seq.sys_user_len) | ((j >= a) & (j <= rows))
    return mask


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float64) / half)
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def served_gaps(params: Dict[str, Any], cfg: Dict[str, Any],
                seqs: Sequence[Seq], device) -> List[List[float]]:
    """For each sequence, the gap (best logit minus the served token's
    logit) at every served position, by the float32 forward over prompt +
    served tokens.  ``cfg``: hidden_size, num_attention_heads,
    num_key_value_heads, rope_theta, rms_norm_eps."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_gaps(params, cfg, seqs, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _served_gaps(params, cfg, seqs, device):
    d = int(cfg["hidden_size"])
    hq = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    hd = d // hq
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    f32 = lambda t: t.to(device=device, dtype=torch.float32)  # noqa: E731
    emb = params["embed"]
    xs = [f32(emb[torch.as_tensor(s.ids, device=emb.device).long()])
          for s in seqs]
    masks = [mask_for(s, device) for s in seqs]
    pos = [torch.arange(len(s.ids), device=device) for s in seqs]
    for layer in params["layers"]:
        w = {k: f32(v) for k, v in layer["attn"].items()}
        m = {k: f32(v) for k, v in layer["mlp"].items()}
        ln1, ln2 = f32(layer["ln1"]), f32(layer["ln2"])
        for n, x in enumerate(xs):
            s = x.shape[0]
            h = _rms(x, ln1, eps)
            q = (h @ w["wq"]).view(s, hq, hd).transpose(0, 1)
            k = (h @ w["wk"]).view(s, hkv, hd).transpose(0, 1)
            v = (h @ w["wv"]).view(s, hkv, hd).transpose(0, 1)
            q, k = _rope(q, pos[n], theta), _rope(k, pos[n], theta)
            k = k.repeat_interleave(hq // hkv, 0)
            v = v.repeat_interleave(hq // hkv, 0)
            sc = (q @ k.transpose(1, 2)) * hd ** -0.5
            sc = sc.masked_fill(~masks[n][None], float("-inf"))
            o = torch.softmax(sc, -1) @ v
            x = x + o.transpose(0, 1).reshape(s, d) @ w["wo"]
            h = _rms(x, ln2, eps)
            x = x + (torch.nn.functional.silu(h @ m["gate"]) * (h @ m["up"])
                     ) @ m["down"]
            xs[n] = x
        del w, m
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
    return out
