"""HF checkpoints -> the port's parameter trees, read without
``transformers``.

Counterpart of ``sdag_tpu/models/hf_convert.py`` for the reference's two
models: the Llama-class generator (meta-llama/Llama-3.1-8B-Instruct) and
the BERT-class E5 ranker (intfloat/e5-large-v2).  A checkpoint dir holds
``config.json`` and ``model.safetensors`` (or a sharded
``model.safetensors.index.json``); ``models/safetensors_io.py`` reads it
one tensor at a time onto the target device.  Nothing is downloaded.

As in the JAX package, the configs never set ``dtype``, so a converted
tree is float32 whatever the checkpoint stores (an 8B tree is 32.1 GB).
HF stores projections as [out, in]; the trees apply ``x @ w`` with w
[in, out], so every such matrix is transposed (and cast) on the device,
one tensor at a time.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any, Callable, Dict, Tuple

import torch

from sdag_tpu_torch.models.e5 import EncoderConfig
from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.models.safetensors_io import open_checkpoint
from sdag_tpu_torch.utils.device import resolve_device

CONFIG_FILE = "config.json"


def read_hf_config(checkpoint_dir: str) -> Dict[str, Any]:
    path = os.path.join(checkpoint_dir, CONFIG_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: an HF checkpoint dir needs a "
                                f"{CONFIG_FILE}")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _getter(hf_cfg) -> Callable[..., Any]:
    """``get(key[, default])`` over a config.json dict or an object with
    attributes (an HF config)."""
    missing = object()

    def get(key, default=missing):
        if isinstance(hf_cfg, Mapping):
            val = hf_cfg.get(key, default)
        else:
            val = getattr(hf_cfg, key, default)
        if val is missing:
            raise KeyError(f"HF config has no {key!r}")
        return val
    return get


def _reader(sd, device: torch.device):
    """``read(name, shape)``: the tensor ``name`` of a state dict (or a
    lazily read checkpoint) on ``device``, checked against ``shape`` (a
    None dim matches any size)."""
    def read(name: str, shape) -> torch.Tensor:
        if name not in sd:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        t = sd[name]
        if len(t.shape) != len(shape) or any(
                s is not None and s != n for s, n in zip(shape, t.shape)):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} "
                             f"!= config shape {tuple(shape)}")
        return t.detach().to(device)
    return read


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """A copy of ``t`` in ``dtype``, contiguous."""
    out = torch.empty(t.shape, dtype=dtype, device=t.device)
    out.copy_(t)
    return out


def _cast_t(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t.T`` in ``dtype``, contiguous, in one copy."""
    out = torch.empty((t.shape[1], t.shape[0]), dtype=dtype, device=t.device)
    out.copy_(t.t())
    return out


# ----------------------------------------------------------------- Llama
def decoder_config_from_hf(hf_cfg) -> DecoderConfig:
    """The JAX ``decoder_config_from_hf``: the same keys, the same
    defaults; ``dtype`` stays float32."""
    get = _getter(hf_cfg)
    scaling = get("rope_scaling", None)
    rope_scaling = None
    if isinstance(scaling, Mapping) and scaling.get(
            "rope_type", scaling.get("type")) == "llama3":
        rope_scaling = (float(scaling["factor"]),
                        float(scaling["low_freq_factor"]),
                        float(scaling["high_freq_factor"]),
                        int(scaling["original_max_position_embeddings"]))
    n_heads = get("num_attention_heads")
    n_kv = get("num_key_value_heads", None)
    return DecoderConfig(
        vocab_size=get("vocab_size"),
        d_model=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=n_heads if n_kv is None else n_kv,
        d_ff=get("intermediate_size"),
        rope_theta=get("rope_theta", 10000.0),
        norm_eps=get("rms_norm_eps", 1e-5),
        tie_embeddings=get("tie_word_embeddings", False),
        rope_scaling=rope_scaling,
    )


def convert_llama_state_dict(sd: Mapping, cfg: DecoderConfig,
                             device="cuda") -> Dict[str, Any]:
    """HF LlamaForCausalLM tensors -> the port's decoder tree on
    ``device`` (the layout of ``params_from_numpy``), in ``cfg.dtype``.
    ``lm_head`` falls back to the embedding when the checkpoint has
    none."""
    dev = resolve_device(device)
    read = _reader(sd, dev)
    d, hd, ff, V = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def w(name, out, inp):
        return _cast_t(read(name, (out, inp)), cfg.dtype)

    def gain(name):
        return _cast(read(name, (d,)), cfg.dtype)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layers.append({
            "attn": {"wq": w(p + "self_attn.q_proj.weight", q_out, d),
                     "wk": w(p + "self_attn.k_proj.weight", kv_out, d),
                     "wv": w(p + "self_attn.v_proj.weight", kv_out, d),
                     "wo": w(p + "self_attn.o_proj.weight", d, q_out)},
            "mlp": {"gate": w(p + "mlp.gate_proj.weight", ff, d),
                    "up": w(p + "mlp.up_proj.weight", ff, d),
                    "down": w(p + "mlp.down_proj.weight", d, ff)},
            "ln1": gain(p + "input_layernorm.weight"),
            "ln2": gain(p + "post_attention_layernorm.weight"),
        })
    params: Dict[str, Any] = {
        "embed": _cast(read("model.embed_tokens.weight", (V, d)), cfg.dtype),
        "layers": layers,
        "final_norm": gain("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        name = ("lm_head.weight" if "lm_head.weight" in sd
                else "model.embed_tokens.weight")
        params["lm_head"] = w(name, V, d)
    return params


def load_decoder_checkpoint(checkpoint_dir: str, device="cuda"
                            ) -> Tuple[Dict[str, Any], DecoderConfig]:
    """A local HF Llama checkpoint dir as (params, config) on ``device``.
    Peak memory is the tree plus one tensor in its stored and its target
    dtype; the shard mappings close before this returns."""
    dev = resolve_device(device)
    cfg = decoder_config_from_hf(read_hf_config(checkpoint_dir))
    with open_checkpoint(checkpoint_dir, device=dev) as sd:
        params = convert_llama_state_dict(sd, cfg, device=dev)
    return params, cfg


# ------------------------------------------------------------------ BERT/E5
def encoder_config_from_hf(hf_cfg) -> EncoderConfig:
    """The JAX ``encoder_config_from_hf``; ``dtype`` stays float32."""
    get = _getter(hf_cfg)
    return EncoderConfig(
        vocab_size=get("vocab_size"),
        d_model=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=get("num_attention_heads"),
        d_ff=get("intermediate_size"),
        max_position=get("max_position_embeddings"),
        norm_eps=get("layer_norm_eps", 1e-12),
    )


def bert_prefix(names) -> str:
    """``"bert."`` when the tensors carry the task models' prefix (as a
    BertForMaskedLM checkpoint does; ``AutoModel`` strips it), else
    ``""``."""
    key = "embeddings.word_embeddings.weight"
    return "bert." if key not in names and "bert." + key in names else ""


def convert_bert_state_dict(sd: Mapping, cfg: EncoderConfig,
                            prefix: str = "", device="cuda"
                            ) -> Dict[str, Any]:
    """HF BertModel tensors -> the port's encoder tree on ``device`` (the
    layout of ``encoder_params_from_numpy``), in ``cfg.dtype``.
    ``embeddings.position_ids`` and ``pooler.*`` are not read."""
    dev = resolve_device(device)
    read = _reader(sd, dev)
    d, ff = cfg.d_model, cfg.d_ff

    def w(name, out, inp):
        return _cast_t(read(prefix + name, (out, inp)), cfg.dtype)

    def b(name, n=d):
        return _cast(read(prefix + name, (n,)), cfg.dtype)

    def ln(p):
        return {"w": b(p + "LayerNorm.weight"), "b": b(p + "LayerNorm.bias")}

    layers = []
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        s = p + "attention.self."
        layers.append({
            "attn": {"wq": w(s + "query.weight", d, d),
                     "bq": b(s + "query.bias"),
                     "wk": w(s + "key.weight", d, d),
                     "bk": b(s + "key.bias"),
                     "wv": w(s + "value.weight", d, d),
                     "bv": b(s + "value.bias"),
                     "wo": w(p + "attention.output.dense.weight", d, d),
                     "bo": b(p + "attention.output.dense.bias")},
            "ln1": ln(p + "attention.output."),
            "mlp": {"w1": w(p + "intermediate.dense.weight", ff, d),
                    "b1": b(p + "intermediate.dense.bias", ff),
                    "w2": w(p + "output.dense.weight", d, ff),
                    "b2": b(p + "output.dense.bias")},
            "ln2": ln(p + "output."),
        })
    e = "embeddings."
    return {
        "word_emb": _cast(read(prefix + e + "word_embeddings.weight",
                               (cfg.vocab_size, d)), cfg.dtype),
        "pos_emb": _cast(read(prefix + e + "position_embeddings.weight",
                              (cfg.max_position, d)), cfg.dtype),
        "type_emb": _cast(read(prefix + e + "token_type_embeddings.weight",
                               (None, d)), cfg.dtype),
        "emb_ln": ln(e),
        "layers": layers,
    }


def load_encoder_checkpoint(checkpoint_dir: str, device="cuda"
                            ) -> Tuple[Dict[str, Any], EncoderConfig]:
    """A local HF BERT/E5 checkpoint dir as (params, config) on
    ``device``."""
    dev = resolve_device(device)
    cfg = encoder_config_from_hf(read_hf_config(checkpoint_dir))
    with open_checkpoint(checkpoint_dir, device=dev) as sd:
        params = convert_bert_state_dict(sd, cfg, prefix=bert_prefix(sd),
                                         device=dev)
    return params, cfg
