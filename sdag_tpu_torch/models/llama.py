"""Llama-class decoder in PyTorch (single device).

Counterpart of ``sdag_tpu/models/llama.py``: RMSNorm, RoPE (with HF
"llama3" frequency scaling), GQA attention, SwiGLU MLP.  The prefill runs
the SDAG block-sparse attention (kernel K1 on CUDA) with document metadata
given, plain causal without; decode attends the whole KV cache causally
(reference decode semantics).

Parameters are a plain dict with the JAX package's tree layout and weight
orientation (``x @ w``, w: [in, out]), so ``params_from_numpy`` maps a JAX
pytree across by key path.  The weight-only int8 tree
(``quantize_decoder_params_int8``, ``LLM_WEIGHTS_DTYPE="int8"``) holds
``{"w": int8 [out, in], "s": f32 [out]}`` leaves: one output channel
contiguous, as kernel K6 (``ops/int8_matmul.py``) streams it; the
embedding ``[V, d]`` already has that layout (per-row scales serve the
gather and the tied unembed).  The forwards dispatch on the leaf type, as
in the JAX package.  The KV cache (native dtype, or int8 with per-slot f32
scales) is updated in place (the JAX package returns a new cache each
step; in place saves a cache-sized copy).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sdag_tpu_torch.ops.attention import (
    masked_decode_attention, masked_decode_attention_int8,
    masked_decode_window_attention, masked_decode_window_attention_int8,
    prefill_mask_plan, quantize_kv_heads_int8, sdag_prefill_attention)
from sdag_tpu_torch.ops.int8_matmul import int8_matmul
from sdag_tpu_torch.sdag.mask import HOLE_DOC_ID
from sdag_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 512
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 512
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.float32
    tie_embeddings: bool = True
    # HF "llama3" RoPE frequency scaling (Llama-3.1+): (factor,
    # low_freq_factor, high_freq_factor, original_max_position). None = off.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "DecoderConfig":
        return DecoderConfig(vocab_size=512, d_model=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=128)

    @staticmethod
    def llama3_8b() -> "DecoderConfig":
        """meta-llama/Llama-3.1-8B-Instruct geometry (reference
        ``config.py:43``)."""
        return DecoderConfig(vocab_size=128256, d_model=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, d_ff=14336,
                             rope_theta=500000.0, dtype=torch.bfloat16,
                             tie_embeddings=False,
                             rope_scaling=(8.0, 1.0, 4.0, 8192))


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        device="cuda") -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (a torch.Generator on
    ``device``): normal * fan_in^-0.5, norm gains 1 -- the JAX init's
    distribution (not its draws: jax.random and torch differ)."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads

    def dense(shape):
        w = torch.empty(shape, dtype=cfg.dtype, device=dev)
        w.normal_(0.0, shape[0] ** -0.5, generator=generator)
        return w

    def ones():
        return torch.ones(d, dtype=cfg.dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn": {"wq": dense((d, n_q * hd)), "wk": dense((d, n_kv * hd)),
                     "wv": dense((d, n_kv * hd)), "wo": dense((n_q * hd, d))},
            "mlp": {"gate": dense((d, cfg.d_ff)), "up": dense((d, cfg.d_ff)),
                    "down": dense((cfg.d_ff, d))},
            "ln1": ones(), "ln2": ones(),
        })
    params: Dict[str, Any] = {"embed": dense((cfg.vocab_size, d)),
                              "layers": layers, "final_norm": ones()}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    return params


def params_from_numpy(tree, cfg: DecoderConfig, device="cuda", _key=None):
    """The JAX package's parameter pytree (nested dicts/lists of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's: float
    leaves in ``cfg.dtype``; the quantized tree's ``{"w": int8, "s": f32}``
    leaves kept int8 / f32, every matrix but the embedding transposed from
    JAX's [in, out] to the port's [out, in]."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        if set(tree) == {"w", "s"} and np.asarray(tree["w"]).dtype == np.int8:
            w = np.asarray(tree["w"])
            if _key != "embed":
                w = w.T
            return {"w": torch.from_numpy(np.array(w, order="C")).to(dev),
                    "s": torch.from_numpy(
                        np.array(tree["s"], np.float32)).to(dev)}
        return {k: params_from_numpy(v, cfg, dev, _key=k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, cfg, dev) for v in tree]
    arr = np.array(tree, dtype=np.float32)
    return torch.from_numpy(arr).to(device=dev, dtype=cfg.dtype)


# channels quantized at once: bounds the f32 copy of a matrix at load
_QUANT_ELEMS = 1 << 24


def _quantize_channels(w: torch.Tensor, axis: int) -> Dict[str, torch.Tensor]:
    """Per-channel symmetric int8 of a float matrix whose channels lie
    along ``axis`` (the JAX rule: scale max(amax, 1e-8) / 127, round half
    to even, clip +-127), as the port's leaf ``{"w": int8 [channels,
    other], "s": f32 [channels]}``.
    The scale divides by a tensor, so it is the same on the CPU and the
    card (a Python-scalar divisor becomes a reciprocal multiply on CUDA)."""
    wt = w if axis == 0 else w.T          # channels along dim 0
    n = wt.shape[0]
    q = torch.empty(wt.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(n, dtype=torch.float32, device=w.device)
    step = max(1, _QUANT_ELEMS // max(1, wt.shape[1]))
    for c0 in range(0, n, step):
        blk = wt[c0:c0 + step].float()
        sc = blk.abs().amax(1).clamp_min(1e-8)
        sc = sc / torch.full_like(sc, 127.0)
        q[c0:c0 + step] = torch.round(blk / sc[:, None]).clamp(
            -127, 127).to(torch.int8)
        s[c0:c0 + step] = sc
    return {"w": q, "s": s}


def quantize_decoder_params_int8(params: Dict[str, Any],
                                 consume: bool = False) -> Dict[str, Any]:
    """Weight-only int8 tree of a float tree (counterpart of the JAX
    package's ``quantize_decoder_params_int8``; its scales and values, bit
    for bit): the embedding per row ([V, d], as stored); ``lm_head``,
    projections and MLP weights per output column, stored transposed as
    [out, in]; norm gains stay float.  ``consume=True`` drops each float
    matrix from ``params`` once it is quantized, so loading the 8B model
    never holds both trees whole."""
    def take(tree, key, axis):
        leaf = _quantize_channels(tree[key], axis)
        if consume:
            tree[key] = None
        return leaf

    out: Dict[str, Any] = {"embed": take(params, "embed", 0),
                           "final_norm": params["final_norm"], "layers": []}
    if "lm_head" in params:
        out["lm_head"] = take(params, "lm_head", 1)
    for layer in params["layers"]:
        out["layers"].append({
            "attn": {k: take(layer["attn"], k, 1)
                     for k in list(layer["attn"])},
            "mlp": {k: take(layer["mlp"], k, 1) for k in list(layer["mlp"])},
            "ln1": layer["ln1"], "ln2": layer["ln2"]})
    return out


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a float weight [in, out] or an int8 leaf (K6 on CUDA
    for decode-shaped x; ops/int8_matmul.py)."""
    if isinstance(w, dict):
        return int8_matmul(x, w["w"], w["s"])
    return x @ w


def _embed_rows(embed, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding gather from a float or int8 table (int8 rows times their
    row scale, both cast to ``dtype`` first, as the JAX package)."""
    ids = ids.long()
    if isinstance(embed, dict):
        return embed["w"][ids].to(dtype) * embed["s"][ids][..., None].to(dtype)
    return embed[ids].to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _llama3_scale_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """HF 'llama3' rope_type frequency rescaling (Llama-3.1)."""
    factor, low_ff, high_ff, orig_max = scaling
    low_wl = orig_max / low_ff
    high_wl = orig_max / high_ff
    wavelen = 2.0 * math.pi / freqs
    scaled = torch.where(wavelen > low_wl, freqs / factor, freqs)
    smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
    smoothed = (1.0 - smooth) / factor * freqs + smooth * freqs
    is_medium = (wavelen <= low_wl) & (wavelen >= high_wl)
    return torch.where(is_medium, smoothed, scaled)


@functools.lru_cache(maxsize=16)
def rope_freqs(half: int, theta: float, rope_scaling,
               device: torch.device) -> torch.Tensor:
    """RoPE frequencies [half] f32, computed once per (geometry, device):
    a decode step, captured in a CUDA graph, reads them and rebuilds
    nothing."""
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / (theta ** exps)
    if rope_scaling is not None:
        freqs = _llama3_scale_freqs(freqs, rope_scaling)
    return freqs


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rope_scaling=None) -> torch.Tensor:
    """Rotary embedding.  x: [B, H, L, Dh]; positions: [B, L]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = rope_freqs(half, theta, rope_scaling, x.device)
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def _project_qkv(attn: Dict[str, Any], x: torch.Tensor, cfg: DecoderConfig):
    """[B, L, d] -> q [B, Hq, L, Dh], k/v [B, Hkv, L, Dh] (contiguous)."""
    B, L, _ = x.shape
    hd = cfg.head_dim

    def heads(y):
        return y.reshape(B, L, y.shape[-1] // hd, hd).transpose(1, 2)

    return (heads(_mm(x, attn["wq"])).contiguous(),
            heads(_mm(x, attn["wk"])).contiguous(),
            heads(_mm(x, attn["wv"])).contiguous())


def _mlp(mlp: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return _mm(torch.nn.functional.silu(_mm(x, mlp["gate"]))
               * _mm(x, mlp["up"]), mlp["down"])


def _unembed(params: Dict[str, Any], cfg: DecoderConfig,
             x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        emb = params["embed"]
        if isinstance(emb, dict):     # per-row scales = unembed channels
            return int8_matmul(x, emb["w"], emb["s"])
        return x @ emb.T
    return _mm(x, params["lm_head"])


def layer_forward(layer: Dict[str, Any], cfg: DecoderConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  doc_id: torch.Tensor, nbr_bits: torch.Tensor,
                  sys_user_len: torch.Tensor, valid_len: torch.Tensor,
                  mask_plan=None):
    """One decoder layer (attention + MLP with residuals).
    Returns (x, (k, v))."""
    B, L, _ = x.shape
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(layer["attn"], h, cfg)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    attn_out = sdag_prefill_attention(q, k, v, doc_id, nbr_bits,
                                      sys_user_len, valid_len=valid_len,
                                      mask_plan=mask_plan)
    attn_out = attn_out.transpose(1, 2).reshape(B, L, -1)
    x = x + _mm(attn_out, layer["attn"]["wo"])
    x = x + _mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps))
    return x, (k, v)


def make_kv_cache(cfg: DecoderConfig, batch: int, size: int,
                  device="cuda", kv_dtype: str = "native"
                  ) -> Dict[str, torch.Tensor]:
    """{k, v}: [n_layers, B, Hkv, size, Dh] in cfg.dtype ('native'), or
    int8 with f32 per-(layer, batch, head, slot) scales ``k_scale`` /
    ``v_scale`` [n_layers, B, Hkv, size] ('int8')."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, size, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], device=dev),
                "v_scale": torch.zeros(shape[:-1], device=dev)}
    if kv_dtype != "native":
        raise ValueError(f"Unknown kv_dtype {kv_dtype!r}: expected "
                         "'native' or 'int8'")
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """K and V quantized per slot in one pass (one set of kernels in a
    decode step): int8 values [2, ...] and f32 scales [2, ...], K first."""
    return quantize_kv_heads_int8(torch.stack([k, v]))


def positions_from_doc_id(doc_id: torch.Tensor) -> torch.Tensor:
    """RoPE positions counting only *active* tokens, so block-aligned hole
    padding (doc_id == HOLE_DOC_ID) does not shift later positions."""
    active = (doc_id != HOLE_DOC_ID).to(torch.int32)
    return (torch.cumsum(active, dim=1) - 1).clamp(min=0).to(torch.int32)


def prefill(params: Dict[str, Any], cfg: DecoderConfig,
            input_ids: torch.Tensor,
            doc_id: Optional[torch.Tensor] = None,
            nbr_bits: Optional[torch.Tensor] = None,
            sys_user_len: Optional[torch.Tensor] = None,
            valid_len: Optional[torch.Tensor] = None,
            cache_size: Optional[int] = None,
            with_cache: bool = True,
            positions: Optional[torch.Tensor] = None,
            logits_last_only: bool = False,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            kv_dtype: str = "native",
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-prompt forward.  input_ids: [B, L] right-padded.

    With doc metadata -> SDAG block-sparse prefill; without -> plain causal
    (doc_id all -1).  Returns (logits [B, L, V] f32, kv cache sized
    cache_size).  logits_last_only=True unembeds only position
    valid_len-1 (logits [B, 1, V]).  ``cache``: a ``make_kv_cache`` result
    of at least L slots to write the prompt's K/V into (slots past L keep
    what they held) instead of a fresh one of ``kv_dtype``; an int8 cache
    takes the K/V quantized per slot."""
    B, L = input_ids.shape
    dev = input_ids.device
    cache_size = cache_size or L
    if doc_id is None:
        doc_id = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    if nbr_bits is None:
        nbr_bits = torch.zeros((B, L), dtype=torch.int32, device=dev)
    if sys_user_len is None:
        sys_user_len = torch.zeros((B,), dtype=torch.int32, device=dev)
    if valid_len is None:
        valid_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    if positions is None:
        positions = positions_from_doc_id(doc_id)
    x = _embed_rows(params["embed"], input_ids, cfg.dtype)

    # layer-invariant kernel metadata (block kinds, live-tile worklists):
    # computed once per prefill, shared by every layer
    mask_plan = prefill_mask_plan(doc_id, nbr_bits, sys_user_len, valid_len)

    if cache is None and with_cache:
        cache = make_kv_cache(cfg, B, cache_size, device=dev,
                              kv_dtype=kv_dtype)
    for li, layer in enumerate(params["layers"]):
        x, (k, v) = layer_forward(layer, cfg, x, positions, doc_id,
                                  nbr_bits, sys_user_len, valid_len,
                                  mask_plan=mask_plan)
        if cache is not None and "k_scale" in cache:
            kv_q, kv_s = _quantize_kv(k, v)
            for i, name in enumerate(("k", "v")):
                cache[name][li, :, :, :L] = kv_q[i]
                cache[f"{name}_scale"][li, :, :, :L] = kv_s[i]
        elif cache is not None:
            cache["k"][li, :, :, :L] = k
            cache["v"][li, :, :, :L] = v

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_last_only:
        last = (valid_len.long() - 1).clamp(min=0)
        x = x[torch.arange(B, device=dev), last][:, None, :]
    logits = _unembed(params, cfg, x).float()
    return logits, cache


def decode_step(params: Dict[str, Any], cfg: DecoderConfig,
                tokens: torch.Tensor,          # [B] current input token
                positions: torch.Tensor,       # [B] true (RoPE) positions
                cache: Dict[str, torch.Tensor],
                write_index,                   # cache slot to write
                cache_mask: torch.Tensor,      # [B, S] valid cache slots
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: plain causal attention over all valid cache slots
    (reference decode semantics, no isolation after prefill).  Writes the
    step's K/V into ``cache`` in place (quantized per slot into an int8
    cache); cache_mask must already include the written slot.
    ``write_index``: an int, or a one-element int64 tensor on the cache's
    device (a step captured in a CUDA graph reads the slot from device
    memory).  Returns (logits [B, V] f32, cache)."""
    B = tokens.shape[0]
    if not isinstance(write_index, torch.Tensor):
        write_index = torch.tensor([write_index], device=tokens.device)
    x = _embed_rows(params["embed"], tokens, cfg.dtype)[:, None, :]  # B,1,d
    pos = positions[:, None]
    int8_kv = "k_scale" in cache
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(layer["attn"], h, cfg)   # [B, H, 1, hd]
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
        if int8_kv:
            kv_q, kv_s = _quantize_kv(k, v)
            for i, name in enumerate(("k", "v")):
                cache[name][li].index_copy_(2, write_index, kv_q[i])
                cache[f"{name}_scale"][li].index_copy_(2, write_index,
                                                       kv_s[i])
            attn_out = masked_decode_attention_int8(
                q[:, :, 0, :], cache["k"][li], cache["v"][li],
                cache["k_scale"][li], cache["v_scale"][li], cache_mask)
        else:
            cache["k"][li].index_copy_(2, write_index, k)
            cache["v"][li].index_copy_(2, write_index, v)
            attn_out = masked_decode_attention(q[:, :, 0, :], cache["k"][li],
                                               cache["v"][li], cache_mask)
        x = x + _mm(attn_out.reshape(B, 1, -1), layer["attn"]["wo"])
        x = x + _mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x)[:, 0, :].float(), cache


def _window_rows(slots: torch.Tensor, G: int) -> torch.Tensor:
    """Slots [B, G] (int64) of a G-token window at per-row bases."""
    return slots.long()[:, None] + torch.arange(G, device=slots.device)


def _update_rows_at(cache_layer: torch.Tensor, new: torch.Tensor,
                    slots: torch.Tensor) -> None:
    """Write G consecutive slots per batch row at per-row bases, in place.

    cache_layer: [B, Hkv, S, Dh]; new: [B, Hkv, G, Dh]; slots: [B] base
    slot per row (a device tensor: a scatter along the slot axis, no host
    value, so a CUDA graph can capture it).  Speculative decoding advances
    each row by its own accepted count, so rows write at diverging
    offsets."""
    rows = _window_rows(slots, new.shape[2])
    cache_layer.scatter_(2, rows[:, None, :, None].expand(new.shape), new)


def _update_scale_rows_at(scale_layer: torch.Tensor, new: torch.Tensor,
                          slots: torch.Tensor) -> None:
    """Per-row scale companion of :func:`_update_rows_at`:
    scale_layer [B, Hkv, S], new [B, Hkv, G], slots [B]."""
    rows = _window_rows(slots, new.shape[2])
    scale_layer.scatter_(2, rows[:, None, :].expand(new.shape), new)


def decode_window(params: Dict[str, Any], cfg: DecoderConfig,
                  tokens: torch.Tensor,        # [B, G] window tokens
                  positions: torch.Tensor,     # [B, G] true (RoPE) positions
                  cache: Dict[str, torch.Tensor],
                  write_slots: torch.Tensor,   # [B] per-row base cache slot
                  cache_mask: torch.Tensor,    # [B, G, S'] valid slots
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative verification step: one forward over a G-token window.

    Each window row attends the cache slots of its ``cache_mask`` row
    (history + the window's causal prefix; the caller builds it), over the
    cache's first S' <= S slots, row by row on a decode step's shapes (so
    a row computes what a decode step would, bit for bit).  K/V of
    all G tokens are written in place at ``write_slots[b] .. + G - 1``
    (quantized per slot into an int8 cache, scales alongside); the caller
    treats only the accepted prefix as history, and the next window starts
    at or before the rejected slots and overwrites them.  Returns (logits
    [B, G, V] f32, cache)."""
    B, G = tokens.shape
    x = _embed_rows(params["embed"], tokens, cfg.dtype)   # [B, G, d]
    int8_kv = "k_scale" in cache
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(layer["attn"], h, cfg)   # [B, H|Hkv, G, hd]
        q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        if int8_kv:
            kv_q, kv_s = _quantize_kv(k, v)
            for i, name in enumerate(("k", "v")):
                _update_rows_at(cache[name][li], kv_q[i], write_slots)
                _update_scale_rows_at(cache[f"{name}_scale"][li], kv_s[i],
                                      write_slots)
            attn_out = masked_decode_window_attention_int8(
                q, cache["k"][li], cache["v"][li], cache["k_scale"][li],
                cache["v_scale"][li], cache_mask)
        else:
            _update_rows_at(cache["k"][li], k, write_slots)
            _update_rows_at(cache["v"][li], v, write_slots)
            attn_out = masked_decode_window_attention(
                q, cache["k"][li], cache["v"][li], cache_mask)
        attn_out = attn_out.transpose(1, 2).reshape(B, G, -1)
        x = x + _mm(attn_out, layer["attn"]["wo"])
        x = x + _mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x).float(), cache
