"""E5-family text encoder (BERT architecture) in PyTorch, one device or
the ranks of a data-parallel mesh.

Counterpart of ``sdag_tpu/models/e5.py``.  Preserves the E5 conventions:
"query: " / "passage: " prefixes when the model name contains "e5", mean
pooling over the attention mask, and L2-normalized outputs.

Parameters are a plain dict with the JAX package's tree layout and weight
orientation (``x @ w``, w: [in, out]); ``encoder_params_from_numpy`` maps a
JAX pytree (plain or fused-QKV) across by key path.  The projections are
plain matmuls; attention goes through kernel K3
(``ops/encoder_attention.py``) when ``fused_attention`` is set.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sdag_tpu_torch.ops.encoder_attention import (encoder_attention_fused,
                                                  encoder_attention_fused_qkv)
from sdag_tpu_torch.parallel.collectives import all_gather_cat
from sdag_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 512
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 256
    max_position: int = 512
    norm_eps: float = 1e-12
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "EncoderConfig":
        return EncoderConfig()

    @staticmethod
    def e5_large_v2() -> "EncoderConfig":
        """intfloat/e5-large-v2 geometry (reference ``config.py:41``)."""
        return EncoderConfig(vocab_size=30522, d_model=1024, n_layers=24,
                             n_heads=16, d_ff=4096, max_position=512,
                             dtype=torch.bfloat16)


def init_encoder_params(generator: torch.Generator, cfg: EncoderConfig,
                        device="cuda") -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (a torch.Generator on
    ``device``): normal * fan_in^-0.5 (embeddings * 0.02), zero biases, unit
    norm gains -- the JAX init's distribution (not its draws: jax.random and
    torch differ)."""
    dev = resolve_device(device)
    d = cfg.d_model

    def dense(shape, scale=None):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, scale or shape[0] ** -0.5, generator=generator)
        return w.to(cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def ln():
        return {"w": torch.ones(d, dtype=cfg.dtype, device=dev),
                "b": zeros(d)}

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": {"wq": dense((d, d)), "bq": zeros(d),
                     "wk": dense((d, d)), "bk": zeros(d),
                     "wv": dense((d, d)), "bv": zeros(d),
                     "wo": dense((d, d)), "bo": zeros(d)},
            "ln1": ln(),
            "mlp": {"w1": dense((d, cfg.d_ff)), "b1": zeros(cfg.d_ff),
                    "w2": dense((cfg.d_ff, d)), "b2": zeros(d)},
            "ln2": ln(),
        })
    return {
        "word_emb": dense((cfg.vocab_size, d), scale=0.02),
        "pos_emb": dense((cfg.max_position, d), scale=0.02),
        "type_emb": torch.zeros(2, d, dtype=cfg.dtype, device=dev),
        "emb_ln": ln(),
        "layers": layers,
    }


def encoder_params_from_numpy(tree, cfg: EncoderConfig, device="cuda"):
    """The JAX package's encoder pytree (nested dicts/lists of numpy
    arrays, plain or ``fuse_qkv_params`` output, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: encoder_params_from_numpy(v, cfg, dev)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [encoder_params_from_numpy(v, cfg, dev) for v in tree]
    arr = np.array(tree, dtype=np.float32)
    return torch.from_numpy(arr).to(device=dev, dtype=cfg.dtype)


def _layer_norm(x, ln, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * ln["w"] \
        + ln["b"]


def fuse_qkv_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Precompute per-layer fused QKV weights (wqkv [d, 3d], bqkv [3d]):
    one matmul replaces three in the forward and its output is K3's packed
    input.  Done once at encoder construction, never per call."""
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        a = layer["attn"]
        a2 = {k: v for k, v in a.items()
              if k not in ("wq", "wk", "wv", "bq", "bk", "bv")}
        a2["wqkv"] = torch.cat([a["wq"], a["wk"], a["wv"]], dim=1)
        a2["bqkv"] = torch.cat([a["bq"], a["bk"], a["bv"]])
        layers.append(dict(layer, attn=a2))
    out["layers"] = layers
    return out


def encoder_forward(params: Dict[str, Any], cfg: EncoderConfig,
                    input_ids: torch.Tensor, attention_mask: torch.Tensor,
                    fused_attention: bool = False,
                    gelu: str = "erf") -> torch.Tensor:
    """Mean-pooled, L2-normalized sentence embeddings.

    input_ids, attention_mask: [B, L].  Returns [B, d] float32.
    Accepts plain params (wq/wk/wv) or :func:`fuse_qkv_params` output.
    fused_attention=True routes attention through
    ``ops/encoder_attention.py`` (kernel K3 on CUDA); it requires the mask
    rows to be contiguous prefixes, which :meth:`E5Encoder._tokenize`
    guarantees.  With fused-QKV params the packed projection output feeds
    the kernel directly.  gelu: "erf" (exact, BERT/HF parity) or "tanh"
    (the standard tanh approximation).
    """
    B, L = input_ids.shape
    x = (params["word_emb"][input_ids.long()] + params["pos_emb"][:L][None]
         + params["type_emb"][0][None, None])
    x = _layer_norm(x, params["emb_ln"], cfg.norm_eps)

    if fused_attention:
        valid_len = attention_mask.to(torch.int32).sum(1, dtype=torch.int32)
        bias = None
    else:
        neg = torch.finfo(torch.float32).min * 0.5
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)

    hd = cfg.head_dim
    for layer in params["layers"]:
        a = layer["attn"]
        if fused_attention and "wqkv" in a:
            qkv = x @ a["wqkv"] + a["bqkv"]     # [B, L, 3d], fed as it is
            ctx = encoder_attention_fused_qkv(qkv, valid_len,
                                              n_heads=cfg.n_heads)
        else:
            if "wqkv" in a:
                qkv = x @ a["wqkv"] + a["bqkv"]
                q, k, v = (t.reshape(B, L, cfg.n_heads, hd)
                           for t in qkv.chunk(3, dim=-1))
            else:
                q = (x @ a["wq"] + a["bq"]).reshape(B, L, cfg.n_heads, hd)
                k = (x @ a["wk"] + a["bk"]).reshape(B, L, cfg.n_heads, hd)
                v = (x @ a["wv"] + a["bv"]).reshape(B, L, cfg.n_heads, hd)
            if fused_attention:
                ctx = encoder_attention_fused(q, k, v, valid_len)
            else:
                scores = torch.einsum("bihd,bjhd->bhij", q.float(),
                                      k.float()) * hd ** -0.5
                probs = torch.softmax(scores + bias, dim=-1).to(x.dtype)
                ctx = torch.einsum("bhij,bjhd->bihd", probs,
                                   v).reshape(B, L, -1)
        x = _layer_norm(x + (ctx @ a["wo"] + a["bo"]), layer["ln1"],
                        cfg.norm_eps)
        m = layer["mlp"]
        h = F.gelu(x @ m["w1"] + m["b1"],
                   approximate="tanh" if gelu == "tanh" else "none")
        x = _layer_norm(x + (h @ m["w2"] + m["b2"]), layer["ln2"],
                        cfg.norm_eps)

    mask = attention_mask[..., None].float()
    pooled = (x.float() * mask).sum(1) / mask.sum(1).clamp_min(1e-9)
    return pooled / torch.linalg.norm(pooled, dim=-1,
                                      keepdim=True).clamp_min(1e-12)


class E5Encoder:
    """Batched encoder with E5 prefixing rules and shape-bucketed batches.

    ``dp_mesh`` (``core/mesh.py``): a batch's rows are split over the
    mesh's ``data`` axis, each rank encodes its slice with the same
    forward (kernel K3 on CUDA) and the embeddings are all-gathered; the
    forward is row-parallel, so every rank's embeddings equal one
    device's.
    """

    def __init__(self, params, cfg: EncoderConfig, tokenizer,
                 model_name: str = "e5", max_length: int = 512,
                 pad_multiple: int = 64, fused: Optional[bool] = None,
                 gelu: Optional[str] = None, device="cuda",
                 dp_mesh=None) -> None:
        self.device = resolve_device(device)
        self.dp_group = None if dp_mesh is None else dp_mesh.group("data")
        self._dp_n = 1 if dp_mesh is None else dp_mesh.shape["data"]
        self._dp_rank = 0 if dp_mesh is None else dp_mesh.rank("data")
        # fused=None: fused QKV + kernel K3 on CUDA, the plain attention on
        # the CPU (the kernel's mask contract is met by _tokenize's
        # contiguous-prefix padding; parity is test-pinned)
        if fused is None:
            fused = self.device.type == "cuda"
        # gelu=None: exact erf everywhere (BERT/HF parity); "tanh" stays
        # selectable.  Decided for the card, where no measurement asks for
        # the approximation.
        if gelu is None:
            gelu = "erf"
        if gelu not in ("erf", "tanh"):
            raise ValueError(f"Unknown gelu {gelu!r}: 'erf' or 'tanh'")
        self.fused = fused
        self.gelu = gelu
        self.params = fuse_qkv_params(params) if fused else params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.is_e5 = "e5" in model_name.lower()
        self.max_length = min(max_length, cfg.max_position)
        self.pad_multiple = pad_multiple
        # tokens (padding excluded / included) and seconds spent in encode
        self.stats = {"tokens": 0, "padded_tokens": 0, "seconds": 0.0,
                      "batches": 0}

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    def _prefix(self, texts: List[str], kind: str) -> List[str]:
        if not self.is_e5 or kind == "raw":
            return list(texts)
        return [f"{kind}: {t}" for t in texts]

    @torch.no_grad()
    def encode(self, texts: List[str], kind: str = "passage",
               batch_size: int = 32) -> np.ndarray:
        """kind: 'query' | 'passage' | 'raw' (controls the E5 prefix,
        cf. reference ``dense.py:59`` / ``malicious_selection.py:32``)."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        prefixed = self._prefix([t or "" for t in texts], kind)
        t0 = time.perf_counter()
        out = []
        for i in range(0, len(prefixed), batch_size):
            ids, mask = self._tokenize(prefixed[i:i + batch_size])
            n = len(ids)
            if self._dp_n > 1:
                # pad rows to the data multiple (all-zero masks pool to
                # the zero vector and are dropped) and take this rank's
                pad = (-n) % self._dp_n
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
                rows = len(ids) // self._dp_n
                r0 = self._dp_rank * rows
                ids, mask = ids[r0:r0 + rows], mask[r0:r0 + rows]
            emb = encoder_forward(
                self.params, self.cfg,
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
                fused_attention=self.fused, gelu=self.gelu)
            emb = all_gather_cat(emb.float(), self.dp_group)
            out.append(emb[:n].cpu().numpy())
            self.stats["tokens"] += int(mask.sum())
            self.stats["padded_tokens"] += int(mask.size)
            self.stats["batches"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return np.vstack(out)

    def _tokenize(self, texts: List[str]):
        # BERT-family tokenizers (SentenceTransformer path, reference
        # dense.py:44-65) wrap every sequence as [CLS] ids[:max-2] [SEP];
        # E5 mean-pools over those specials too, so they must be present
        # for real-checkpoint embedding parity.  Tokenizers without
        # cls/sep (the byte fallback) keep the plain truncation rule.
        cls_id = getattr(self.tokenizer, "cls_token_id", None)
        sep_id = getattr(self.tokenizer, "sep_token_id", None)
        if cls_id is not None and sep_id is not None:
            body = self.max_length - 2
            rows = [[cls_id]
                    + self.tokenizer.encode(t, add_special_tokens=False)[:body]
                    + [sep_id] for t in texts]
        else:
            rows = [self.tokenizer.encode(t, add_special_tokens=False)
                    [: self.max_length] for t in texts]
        lp = max(1, max(len(r) for r in rows))
        lp = min(((lp + self.pad_multiple - 1) // self.pad_multiple)
                 * self.pad_multiple, self.max_length)
        ids = np.zeros((len(rows), lp), np.int32)
        mask = np.zeros((len(rows), lp), np.int32)
        for i, r in enumerate(rows):
            r = r[:lp]
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask
