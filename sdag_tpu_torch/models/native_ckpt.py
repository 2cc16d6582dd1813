"""Native (non-HF) decoder checkpoints, read and written without JAX.

Format (the JAX package's ``models/native_ckpt.py``): ``native_decoder.json``
(``{"config": the DecoderConfig, "extra": ...}``) next to ``params.npz``
(the parameter tree flattened to '/'-joined key paths, f32).  Each package
reads what the other writes.  The pipeline's ``LLM_CHECKPOINT`` accepts
such a directory (pipeline/resources.py); ``pipeline/train_qa.py`` writes
one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.tree import flatten_with_paths

MANIFEST = "native_decoder.json"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}
# DecoderConfig fields the JAX package's has not (a model needs them only
# where it sets them apart from their defaults)
_PORT_ONLY = ("head_dim", "layer_types", "sliding_window", "rope_yarn",
              "n_experts", "experts_per_token", "expert_ff", "norm_topk_prob")


def save_decoder(params: Dict[str, Any], cfg: DecoderConfig, out_dir: str,
                 extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a float parameter tree (the JAX layout, any device) and its
    config as a native checkpoint directory."""
    os.makedirs(out_dir, exist_ok=True)
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["dtype"] = _NAMES[cfg.dtype]
    if cfg == dataclasses.replace(cfg, **{
            f.name: f.default for f in dataclasses.fields(cfg)
            if f.name in _PORT_ONLY}):
        # a plain decoder's manifest keeps the JAX package's keys only
        for key in _PORT_ONLY:
            del cfg_dict[key]
    with open(os.path.join(out_dir, MANIFEST), "w") as fh:
        json.dump({"config": cfg_dict, "extra": extra or {}}, fh, indent=1)
    flat = {k: v.detach().float().cpu().numpy()
            for k, v in flatten_with_paths(params).items()}
    np.savez(os.path.join(out_dir, "params.npz"), **flat)


def is_native_checkpoint(path: str) -> bool:
    return bool(path) and os.path.isfile(os.path.join(path, MANIFEST))


def load_config(ckpt_dir: str) -> DecoderConfig:
    with open(os.path.join(ckpt_dir, MANIFEST)) as fh:
        man = json.load(fh)
    cfg_dict = dict(man["config"])
    cfg_dict["dtype"] = _DTYPES.get(cfg_dict.get("dtype", "float32"),
                                    torch.float32)
    for key in ("rope_scaling", "layer_types", "rope_yarn"):
        if cfg_dict.get(key) is not None:
            cfg_dict[key] = tuple(cfg_dict[key])
    return DecoderConfig(**cfg_dict)


def load_decoder(ckpt_dir: str, device="cuda"
                 ) -> Tuple[Dict[str, Any], DecoderConfig]:
    """(params, cfg) with the JAX package's tree layout, on ``device``."""
    dev = resolve_device(device)
    cfg = load_config(ckpt_dir)
    data = np.load(os.path.join(ckpt_dir, "params.npz"))
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    shapes = {
        "attn/wq": (d, cfg.n_heads * hd), "attn/wk": (d, cfg.n_kv_heads * hd),
        "attn/wv": (d, cfg.n_kv_heads * hd), "attn/wo": (cfg.n_heads * hd, d),
        "mlp/gate": (d, ff), "mlp/up": (d, ff), "mlp/down": (ff, d),
        "ln1": (d,), "ln2": (d,),
    }

    def get(key, shape):
        arr = np.asarray(data[key], np.float32)
        if arr.shape != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"config shape {shape}")
        return torch.from_numpy(arr).to(device=dev, dtype=cfg.dtype)

    layers = []
    for li in range(cfg.n_layers):
        flat = {name: get(f"layers/{li}/{name}", shape)
                for name, shape in shapes.items()}
        layers.append({
            "attn": {w: flat[f"attn/{w}"] for w in ("wq", "wk", "wv", "wo")},
            "mlp": {w: flat[f"mlp/{w}"] for w in ("gate", "up", "down")},
            "ln1": flat["ln1"], "ln2": flat["ln2"]})
    params: Dict[str, Any] = {
        "embed": get("embed", (cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": get("final_norm", (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = get("lm_head", (d, cfg.vocab_size))
    return params, cfg
