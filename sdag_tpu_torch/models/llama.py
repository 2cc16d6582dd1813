"""Llama-class decoder in PyTorch (one device, or one tensor-parallel rank).

Counterpart of ``sdag_tpu/models/llama.py``: RMSNorm, RoPE (with HF
"llama3" frequency scaling), GQA attention, SwiGLU MLP.  The prefill runs
the SDAG block-sparse attention (kernel K1 on CUDA) with document metadata
given, plain causal without; decode attends the whole KV cache causally
(reference decode semantics; over a native cache each layer's RoPE, K/V
write and attention are kernel K7 on CUDA).  Prefill, the decode step and
the verification window run one layer body (``_layer``); the KV cache's
format is read in one place (``_layer_kv``).

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
    apply_rope, decode_attention, masked_decode_attention_int8,
    masked_decode_window_attention, masked_decode_window_attention_int8,
    prefill_dense_mask, prefill_mask_plan, quantize_kv_heads_int8,
    sdag_attention_dense, sdag_prefill_attention)
from sdag_tpu_torch.ops.int8_matmul import int8_matmul
from sdag_tpu_torch.ops.moe import moe_decode, moe_prefill
from sdag_tpu_torch.ops.norm import add_rms_norm, rms_norm  # noqa: F401
from sdag_tpu_torch.parallel.collectives import (copy_to_group,
                                                 gather_from_group,
                                                 reduce_from_group)
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
    # a head's width where the model sets it apart from d_model // n_heads
    # (0: that quotient; the q width is n_heads * head_dim)
    head_dim: int = 0
    # each layer's attention, "full_attention" or "sliding_attention"
    # (None: every layer full).  A windowed layer's query i sees key j only
    # where the SDAG (or causal) rule allows it and pos_i - pos_j <
    # sliding_window, positions being the RoPE positions (HF's convention:
    # its own key is one of the window's keys)
    layer_types: Optional[Tuple[str, ...]] = None
    sliding_window: int = 0
    # HF "yarn" RoPE of the full layers (factor, original_max_position,
    # beta_fast, beta_slow, attention_factor); windowed layers take plain
    # RoPE at rope_theta.  HF multiplies cos and sin by the attention
    # factor; here its square multiplies the layer's softmax scale, which
    # gives the same scores
    rope_yarn: Optional[Tuple[float, int, float, float, float]] = None
    # sparse experts in every layer's MLP (0: the dense SwiGLU): a router
    # [d, n_experts], softmax in f32, the top experts_per_token (divided by
    # their sum with norm_topk_prob), each a SwiGLU of width expert_ff
    n_experts: int = 0
    experts_per_token: int = 0
    expert_ff: int = 0
    norm_topk_prob: bool = True

    def __post_init__(self) -> None:
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layer_types is not None:
            if len(self.layer_types) != self.n_layers or not set(
                    self.layer_types) <= {"full_attention",
                                          "sliding_attention"}:
                raise ValueError(f"layer_types {self.layer_types!r}: one of "
                                 "'full_attention' / 'sliding_attention' a "
                                 "layer")
            if "sliding_attention" in self.layer_types \
                    and self.sliding_window < 1:
                raise ValueError("sliding layers need sliding_window >= 1")

    def windowed(self, li: int) -> bool:
        """Layer ``li`` attends a sliding window."""
        return self.layer_types is not None \
            and self.layer_types[li] == "sliding_attention"

    @property
    def has_windows(self) -> bool:
        return self.layer_types is not None \
            and "sliding_attention" in self.layer_types

    def window(self, li: int) -> int:
        """Keys a query of layer ``li`` may see back (0: no window)."""
        return self.sliding_window if self.windowed(li) else 0

    def layer_rope(self, li: int):
        """(theta, llama3 scaling, yarn) of layer ``li``'s RoPE."""
        if self.windowed(li):
            return self.rope_theta, None, None
        return self.rope_theta, self.rope_scaling, self.rope_yarn

    def attn_scale(self, li: int) -> Optional[float]:
        """Layer ``li``'s softmax scale where it is not head_dim ** -0.5
        (YaRN's attention factor squared), else None."""
        if self.rope_yarn is None or self.windowed(li):
            return None
        return self.rope_yarn[4] ** 2 * self.head_dim ** -0.5

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

    @staticmethod
    def mellum2_12b_a2p5b() -> "DecoderConfig":
        """JetBrains/Mellum2-12B-A2.5B-Instruct's config.json: 28 layers,
        three windowed (1,024 keys) to one full, YaRN on the full ones, 64
        experts of width 896, 8 a token, head dim 128 beside a 2,304
        hidden size; no MTP head (the config declares none)."""
        return DecoderConfig(
            vocab_size=98304, d_model=2304, n_layers=28, n_heads=32,
            n_kv_heads=4, d_ff=7168, rope_theta=500000.0, norm_eps=1e-6,
            dtype=torch.bfloat16, tie_embeddings=False, head_dim=128,
            layer_types=(("sliding_attention",) * 3
                         + ("full_attention",)) * 7, sliding_window=1024,
            rope_yarn=(16.0, 8192, 32.0, 1.0, 1.2772588722239782),
            n_experts=64, experts_per_token=8, expert_ff=896,
            norm_topk_prob=True)


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        device="cuda") -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (a torch.Generator on
    ``device``): normal * fan_in^-0.5, norm gains 1 -- the JAX init's
    distribution (not its draws: jax.random and torch differ)."""
    dev = resolve_device(device)
    d, hd = cfg.d_model, cfg.head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads

    def dense(shape, fan_in=None):
        w = torch.empty(shape, dtype=cfg.dtype, device=dev)
        w.normal_(0.0, (fan_in or shape[0]) ** -0.5, generator=generator)
        return w

    def ones():
        return torch.ones(d, dtype=cfg.dtype, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn": {"wq": dense((d, n_q * hd)), "wk": dense((d, n_kv * hd)),
                     "wv": dense((d, n_kv * hd)), "wo": dense((n_q * hd, d))},
            "ln1": ones(), "ln2": ones(),
        }
        if cfg.n_experts:
            # experts [E, out, in] (ops/moe.py): fan_in is the last axis
            e, f = cfg.n_experts, cfg.expert_ff
            layer["moe"] = {"router": dense((d, e)),
                            "gate_up": dense((e, 2 * f, d), d),
                            "down": dense((e, d, f), f)}
        else:
            layer["mlp"] = {"gate": dense((d, cfg.d_ff)),
                            "up": dense((d, cfg.d_ff)),
                            "down": dense((cfg.d_ff, d))}
        layers.append(layer)
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


def yarn_ramp_bounds(half: int, theta: float, yarn) -> Tuple[float, float]:
    """HF ``_compute_yarn_parameters``' correction range (low, high) over
    the ``half`` frequencies: the dims where beta_fast and beta_slow
    rotations fit the original context, floored and ceiled."""
    _, orig, beta_fast, beta_slow, _ = yarn
    dim = 2 * half

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(theta))

    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    return low, (high + 0.001 if low == high else high)


@functools.lru_cache(maxsize=16)
def rope_freqs(half: int, theta: float, rope_scaling,
               device: torch.device, yarn=None) -> torch.Tensor:
    """RoPE frequencies [half] f32, computed once per (geometry, device):
    a decode step, captured in a CUDA graph, reads them and rebuilds
    nothing.  ``yarn``: HF's YaRN blend of the frequencies (extrapolated)
    and the frequencies over ``factor`` (interpolated), by a linear ramp
    between ``yarn_ramp_bounds``."""
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    freqs = 1.0 / (theta ** exps)
    if rope_scaling is not None:
        freqs = _llama3_scale_freqs(freqs, rope_scaling)
    if yarn is not None:
        low, high = yarn_ramp_bounds(half, theta, yarn)
        ramp = ((torch.arange(half, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0, 1)
        interp = 1.0 / (yarn[0] * theta ** exps)
        freqs = interp * ramp + freqs * (1 - ramp)
    return freqs


def layer_freqs(cfg: DecoderConfig, li: int,
                device: torch.device) -> torch.Tensor:
    """Layer ``li``'s RoPE frequencies (``DecoderConfig.layer_rope``)."""
    theta, scaling, yarn = cfg.layer_rope(li)
    return rope_freqs(cfg.head_dim // 2, theta, scaling, device, yarn)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         rope_scaling=None, yarn=None) -> torch.Tensor:
    """Rotary embedding.  x: [B, H, L, Dh]; positions: [B, L]."""
    return apply_rope(x, positions, rope_freqs(x.shape[-1] // 2, theta,
                                               rope_scaling, x.device, yarn))


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
             x: torch.Tensor, tp_group=None) -> torch.Tensor:
    """Vocab logits.  Under tensor parallelism an untied lm_head holds
    this rank's vocab columns and the slices are all-gathered; a tied
    embedding is whole on every rank."""
    if cfg.tie_embeddings:
        emb = params["embed"]
        if isinstance(emb, dict):     # per-row scales = unembed channels
            return int8_matmul(x, emb["w"], emb["s"])
        return x @ emb.T
    return gather_from_group(_mm(copy_to_group(x, tp_group),
                                 params["lm_head"]), tp_group, dim=-1)


def layer_mask_plan(doc_id, nbr_bits, sys_user_len, valid_len,
                    attn_impl: str = "auto", window: int = 0,
                    positions=None):
    """The attention metadata of one forward that every layer of a kind
    shares: K1's plan (``attn_impl="auto"``; None on the CPU) or the dense
    mask of the differentiable path (``"xla"``); ``window`` > 0 (with the
    RoPE ``positions``) for the windowed layers."""
    if attn_impl == "auto":
        return prefill_mask_plan(doc_id, nbr_bits, sys_user_len, valid_len,
                                 window=window, positions=positions)
    if attn_impl == "xla":
        return prefill_dense_mask(doc_id, nbr_bits, sys_user_len, valid_len,
                                  window=window, positions=positions)
    raise ValueError(f"attn_impl {attn_impl!r}: expected 'auto' or 'xla'")


def token_rows(doc_id: torch.Tensor, valid_len: torch.Tensor) -> torch.Tensor:
    """The prompt's tokens, neither right padding nor holes, as int64
    indices into the B * L rows (the rows an expert layer routes)."""
    cols = torch.arange(doc_id.shape[1], device=doc_id.device)[None, :]
    valid = (cols < valid_len[:, None]) & (doc_id != HOLE_DOC_ID)
    return valid.reshape(-1).nonzero()[:, 0]


def _layer(layer: Dict[str, Any], cfg: DecoderConfig, li: int,
           x: torch.Tensor, pending: Optional[torch.Tensor], attend, mask,
           window_mask, experts, tp_group=None):
    """Decoder layer ``li``, the one body of ``layer_forward`` (prefill,
    GPipe), ``decode_step`` and ``decode_window``.  The layer's kind sets
    its RoPE frequencies, softmax scale and mask (``window_mask`` for a
    windowed layer, else ``mask``); how the K/V are read and written is
    the caller's ``attend(li, q, k, v, freqs, scale, mask)`` -> (out [B,
    Hq, L, Dh], kv), q/k/v unrotated; ``experts(li, moe, h)`` runs an
    expert layer.  ``pending``: the previous layer's MLP output, added in
    the first norm.  Returns (x, out, kv), the output x + out."""
    B, L, _ = x.shape
    x, h = add_rms_norm(x, pending, layer["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(layer["attn"], copy_to_group(h, tp_group), cfg)
    attn, kv = attend(li, q, k, v, layer_freqs(cfg, li, x.device),
                      cfg.attn_scale(li),
                      window_mask if cfg.windowed(li) else mask)
    attn = reduce_from_group(_mm(attn.transpose(1, 2).reshape(B, L, -1),
                                 layer["attn"]["wo"]), tp_group)
    x, h = add_rms_norm(x, attn, layer["ln2"], cfg.norm_eps)
    h = copy_to_group(h, tp_group)
    if cfg.n_experts:
        return x, experts(li, layer["moe"], h), kv
    return x, reduce_from_group(_mlp(layer["mlp"], h), tp_group), kv


def layer_forward(layer: Dict[str, Any], cfg: DecoderConfig,
                  x: torch.Tensor, positions: torch.Tensor,
                  doc_id: torch.Tensor, nbr_bits: torch.Tensor,
                  sys_user_len: torch.Tensor, valid_len: torch.Tensor,
                  mask_plan=None, tp_group=None, attn_impl: str = "auto",
                  li: int = 0, rows=None, stats=None, routes=None,
                  residual: Optional[torch.Tensor] = None):
    """One decoder layer over a prompt (attention + MLP with residuals).
    Returns (x, mlp_out, (k, v)), k rotated: the layer's output is x +
    mlp_out, an add left to the caller's next norm (the next layer's
    ``residual``, or the final norm), so that each residual add shares a
    launch with the norm after it (``add_rms_norm``, kernel K9 on CUDA).

    residual: the previous layer's MLP output not yet added to ``x`` (None
    for the first layer); its add runs in this layer's first norm.

    attn_impl: "auto" runs ``sdag_prefill_attention`` (kernel K1 on CUDA,
    which has no backward and raises under autograd); "xla" the
    differentiable dense-mask attention the JAX package trains through.
    mask_plan: ``layer_mask_plan``'s result for this impl (built here when
    None).  tp_group: the tensor-parallel process group when the layer
    holds Megatron-sliced weights (``parallel/sharding.py``): attention
    runs on this rank's heads, the MLP on its ff slice, and the wo / down
    products are all-reduced; q/k/v and the KV cache are the local heads.
    Under autograd the collectives are Megatron's Functions (the norms'
    outputs all-reduce their gradients), so the layer trains.
    li: the layer's index (its kind sets RoPE, window and softmax scale;
    ``mask_plan`` must be one of its kind).  An expert layer routes the
    ``rows`` rows only (``token_rows``; built here when None), adds its
    (token, expert) rows to ``stats["moe_prefill_rows"]`` and (rows,
    picks) to the list ``routes``."""
    window = cfg.window(li)
    if mask_plan is None:
        mask_plan = layer_mask_plan(doc_id, nbr_bits, sys_user_len,
                                    valid_len, attn_impl, window=window,
                                    positions=positions)
    if cfg.n_experts and rows is None:
        rows = token_rows(doc_id, valid_len)

    def attend(li, q, k, v, freqs, scale, plan):
        q = apply_rope(q, positions, freqs)
        k = apply_rope(k, positions, freqs)
        if attn_impl == "xla":
            return sdag_attention_dense(q, k, v, plan, scale=scale), (k, v)
        return sdag_prefill_attention(
            q, k, v, doc_id, nbr_bits, sys_user_len, valid_len=valid_len,
            scale=scale, mask_plan=plan, window=window,
            positions=positions), (k, v)

    def experts(li, moe, h):
        return moe_prefill(moe, cfg, h, rows, stats, routes)

    return _layer(layer, cfg, li, x, residual, attend, mask_plan, mask_plan,
                  experts, tp_group)


def make_kv_cache(cfg: DecoderConfig, batch: int, size: int,
                  device="cuda", kv_dtype: str = "native",
                  n_kv_heads: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """{k, v}: [n_layers, B, Hkv, size, Dh] in cfg.dtype ('native'), or
    int8 with f32 per-(layer, batch, head, slot) scales ``k_scale`` /
    ``v_scale`` [n_layers, B, Hkv, size] ('int8').  ``n_kv_heads``
    overrides the config's (a tensor-parallel rank holds its slice)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, n_kv_heads or cfg.n_kv_heads, size,
             cfg.head_dim)
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


def local_kv_heads(params: Dict[str, Any], cfg: DecoderConfig) -> int:
    """KV heads the tree's wk produces: the config's on one rank, its
    slice under tensor parallelism."""
    wk = params["layers"][0]["attn"]["wk"]
    out = wk["w"].shape[0] if isinstance(wk, dict) else wk.shape[1]
    return out // cfg.head_dim


def _layer_kv(cache: Dict[str, torch.Tensor], li: int, k=None, v=None,
              slot: Optional[torch.Tensor] = None,
              rows: Optional[torch.Tensor] = None):
    """Layer ``li`` of the KV cache as (k, v, k_scale, v_scale), the
    scales None in a native cache: the one place that reads its format.
    Given ``k`` and ``v`` [B, Hkv, n, Dh] (k rotated) it first writes
    them in place, quantized per slot into an int8 cache: into slots [0,
    n) (a prompt; a slice copy, no index read an element), the slot
    ``slot`` (int64 [1], a step's) or n slots from each row's base
    ``rows`` [B] (a window: rows advance by their own accepted counts),
    indices on the device (a CUDA graph captures the write)."""
    int8 = "k_scale" in cache
    names = ("k", "v", "k_scale", "v_scale") if int8 else ("k", "v")
    layer = [cache[name][li] for name in names]
    if k is not None:
        if int8:      # K and V in one pass: one set of kernels
            vals, scales = quantize_kv_heads_int8(torch.stack([k, v]))
            new = [*vals, *scales]
        else:
            new = [k, v]
        B, _, n = k.shape[:3]
        if rows is not None:
            idx = rows.long()[:, None] + torch.arange(n, device=rows.device)
        for dst, t in zip(layer, new):
            if slot is not None:
                dst.index_copy_(2, slot, t)
            elif rows is not None:     # scales [B, Hkv, n], values + Dh
                dst.scatter_(2, idx.view(B, 1, n, *(1,) * (t.dim() - 3))
                             .expand(t.shape), t)
            else:
                dst[:, :, :n] = t
    return tuple(layer) if int8 else (*layer, None, None)


def _step_attention(cache, write_index, positions, li, q, k, v, freqs, scale,
                    mask):
    """A decode step's ``attend`` (``_layer``): over a native cache
    ``decode_attention`` (kernel K7 on CUDA: RoPE, the K/V write at
    ``write_index``, attention); over an int8 one RoPE, the quantized
    write and ``masked_decode_attention_int8``."""
    k_c, v_c, k_s, v_s = _layer_kv(cache, li)
    if k_s is None:
        return decode_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], k_c,
                                v_c, mask, write_index, positions, freqs,
                                scale=scale)[:, :, None], None
    pos = positions[:, None]
    q = apply_rope(q, pos, freqs)
    _layer_kv(cache, li, apply_rope(k, pos, freqs), v, slot=write_index)
    return masked_decode_attention_int8(q[:, :, 0], k_c, v_c, k_s, v_s,
                                        mask, scale)[:, :, None], None


def _window_attention(cache, write_slots, positions, li, q, k, v, freqs,
                      scale, mask):
    """A verification window's ``attend``: RoPE, the K/V write at each
    row's base slot, then row by row over the cache by its format."""
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    k_c, v_c, k_s, v_s = _layer_kv(cache, li, k, v, rows=write_slots)
    if k_s is None:
        return masked_decode_window_attention(q, k_c, v_c, mask, scale), None
    return masked_decode_window_attention_int8(q, k_c, v_c, k_s, v_s, mask,
                                               scale), None


def _decode_layers(params, cfg: DecoderConfig, x: torch.Tensor, attend,
                   mask, window_mask, tp_group, moe_reads=None,
                   row_live=None, moe_routes=None) -> torch.Tensor:
    """``decode_step``'s and ``decode_window``'s forward from the embedded
    tokens x [B, G, d]: every ``_layer`` (an expert layer's B * G rows
    through ``moe_decode``), the final norm, the vocab logits."""
    if cfg.has_windows and window_mask is None:
        raise ValueError("decode: a model with windowed layers needs "
                         "window_mask")

    def experts(li, moe, h):
        return moe_decode(moe, cfg, h.reshape(-1, h.shape[-1]), moe_reads,
                          row_live, None if moe_routes is None
                          else moe_routes[li]).reshape(h.shape)

    pending = None     # a layer's MLP output, added in the next norm
    for li, layer in enumerate(params["layers"]):
        x, pending, _ = _layer(layer, cfg, li, x, pending, attend, mask,
                               window_mask, experts, tp_group)
    _, x = add_rms_norm(x, pending, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x, tp_group)


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
            kv_dtype: str = "native", tp_group=None,
            attn_impl: str = "auto", stats=None, routes=None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-prompt forward.  input_ids: [B, L] right-padded.

    With doc metadata -> SDAG block-sparse prefill; without -> plain causal
    (doc_id all -1).  Returns (logits [B, L, V] f32, kv cache sized
    cache_size).  logits_last_only=True unembeds only position
    valid_len-1 (logits [B, 1, V]).  ``cache``: a ``make_kv_cache`` result
    of at least L slots to write the prompt's K/V into (slots past L keep
    what they held) instead of a fresh one of ``kv_dtype``; an int8 cache
    takes the K/V quantized per slot.  ``tp_group``, ``attn_impl``: as
    in ``layer_forward`` ("xla" trains; "auto" serves through K1).
    ``stats``: a dict an expert model counts its routed rows in
    (``layer_forward``).  ``routes``: a list an expert model appends each
    layer's (rows, picks) to (``moe_prefill``)."""
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

    # the metadata every layer of a kind shares (K1's block kinds and
    # live-tile worklists, or the dense mask): computed once per prefill
    # and kind (full, windowed)
    plans = {w: layer_mask_plan(doc_id, nbr_bits, sys_user_len, valid_len,
                                attn_impl, window=w, positions=positions)
             for w in sorted({cfg.window(li) for li in range(cfg.n_layers)})}
    rows = token_rows(doc_id, valid_len) if cfg.n_experts else None

    if cache is None and with_cache:
        cache = make_kv_cache(cfg, B, cache_size, device=dev,
                              kv_dtype=kv_dtype,
                              n_kv_heads=local_kv_heads(params, cfg))
    pending = None     # a layer's MLP output, added in the next norm
    for li, layer in enumerate(params["layers"]):
        x, pending, (k, v) = layer_forward(
            layer, cfg, x, positions, doc_id, nbr_bits, sys_user_len,
            valid_len, mask_plan=plans[cfg.window(li)], tp_group=tp_group,
            attn_impl=attn_impl, li=li, rows=rows, stats=stats,
            routes=routes, residual=pending)
        if cache is not None:
            _layer_kv(cache, li, k, v)

    _, x = add_rms_norm(x, pending, params["final_norm"], cfg.norm_eps)
    if logits_last_only:
        last = (valid_len.long() - 1).clamp(min=0)
        x = x[torch.arange(B, device=dev), last][:, None, :]
    logits = _unembed(params, cfg, x, tp_group).float()
    return logits, cache


def decode_step(params: Dict[str, Any], cfg: DecoderConfig,
                tokens: torch.Tensor,          # [B] current input token
                positions: torch.Tensor,       # [B] true (RoPE) positions
                cache: Dict[str, torch.Tensor],
                write_index,                   # cache slot to write
                cache_mask: torch.Tensor,      # [B, S] valid cache slots
                tp_group=None, window_mask=None, moe_reads=None,
                row_live=None, moe_routes=None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: plain causal attention over all valid cache slots
    (reference decode semantics, no isolation after prefill).  Writes the
    step's K/V into ``cache`` in place (quantized per slot into an int8
    cache); cache_mask must already include the written slot.  Over a
    native cache each layer's RoPE, K/V write and attention are one
    ``decode_attention`` (kernel K7 on CUDA).
    ``write_index``: an int, or a one-element int64 tensor on the cache's
    device (a step captured in a CUDA graph reads the slot from device
    memory).  ``tp_group``: as in ``layer_forward``.  ``window_mask``
    [B, S]: the windowed layers' slots (cache_mask less the slots a
    window's width or more behind the step's position; needed when the
    model has such layers).  An expert model runs each layer's routing and
    experts as one ``moe_decode`` (kernel K8 on CUDA) over the rows
    ``row_live`` marks (all when None), counting the experts it reads in
    ``moe_reads`` (int64 [1], on the device) and writing its picks to
    ``moe_routes`` (int32 [layers, B, k], -1 for a row not live) where
    given.  Returns (logits [B, V] f32, cache)."""
    if not isinstance(write_index, torch.Tensor):
        write_index = torch.tensor([write_index], device=tokens.device)
    x = _embed_rows(params["embed"], tokens, cfg.dtype)[:, None, :]  # B,1,d
    logits = _decode_layers(
        params, cfg, x, functools.partial(_step_attention, cache,
                                          write_index, positions),
        cache_mask, window_mask, tp_group, moe_reads, row_live, moe_routes)
    return logits[:, 0, :].float(), cache


def decode_window(params: Dict[str, Any], cfg: DecoderConfig,
                  tokens: torch.Tensor,        # [B, G] window tokens
                  positions: torch.Tensor,     # [B, G] true (RoPE) positions
                  cache: Dict[str, torch.Tensor],
                  write_slots: torch.Tensor,   # [B] per-row base cache slot
                  cache_mask: torch.Tensor,    # [B, G, S'] valid slots
                  tp_group=None, window_mask=None,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative verification step: one forward over a G-token window.

    Each window row attends the cache slots of its ``cache_mask`` row
    (history + the window's causal prefix; the caller builds it), over the
    cache's first S' <= S slots, row by row on a decode step's shapes (so
    a row computes what a decode step would, bit for bit).  K/V of
    all G tokens are written in place at ``write_slots[b] .. + G - 1``
    (quantized per slot into an int8 cache, scales alongside); the caller
    treats only the accepted prefix as history, and the next window starts
    at or before the rejected slots and overwrites them.  ``tp_group``: as
    in ``layer_forward``.  ``window_mask`` [B, G, S']: ``decode_step``'s,
    a row each.  Returns (logits [B, G, V] f32, cache)."""
    x = _embed_rows(params["embed"], tokens, cfg.dtype)   # [B, G, d]
    logits = _decode_layers(
        params, cfg, x, functools.partial(_window_attention, cache,
                                          write_slots, positions),
        cache_mask, window_mask, tp_group)
    return logits.float(), cache
