"""Native (non-HF) decoder checkpoints, read without JAX.

Format (written by the JAX package's ``models/native_ckpt.save_decoder``):
``native_decoder.json`` (the DecoderConfig) next to ``params.npz`` (the
parameter tree flattened to '/'-joined key paths, f32).  The pipeline's
``LLM_CHECKPOINT`` accepts such a directory (pipeline/resources.py).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.utils.device import resolve_device

MANIFEST = "native_decoder.json"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def is_native_checkpoint(path: str) -> bool:
    return bool(path) and os.path.isfile(os.path.join(path, MANIFEST))


def load_config(ckpt_dir: str) -> DecoderConfig:
    with open(os.path.join(ckpt_dir, MANIFEST)) as fh:
        man = json.load(fh)
    cfg_dict = dict(man["config"])
    cfg_dict["dtype"] = _DTYPES.get(cfg_dict.get("dtype", "float32"),
                                    torch.float32)
    if cfg_dict.get("rope_scaling") is not None:
        cfg_dict["rope_scaling"] = tuple(cfg_dict["rope_scaling"])
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
