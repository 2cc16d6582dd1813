"""Megatron tensor-parallel slicing of the decoder's parameters.

Counterpart of ``sdag_tpu/parallel/sharding.py``: attention wq/wk/wv and
MLP gate/up split their output columns over ``model``, wo and MLP down
their input rows (the forward all-reduces their partial products), an
untied lm_head its vocab columns (the logits are all-gathered); the
embedding, the norms and a tied head stay whole.  A spec is the JAX
``PartitionSpec`` as a tuple: per dimension the axis it is split over, or
None.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from sdag_tpu_torch.core.mesh import Mesh, replicate
from sdag_tpu_torch.models.llama import DecoderConfig

COL = (None, "model")
ROW = ("model", None)


def decoder_param_specs(cfg: DecoderConfig) -> Dict[str, Any]:
    """Spec tree matching ``init_decoder_params``' structure (and the JAX
    package's ``decoder_param_specs``)."""
    layer_spec = {
        "attn": {"wq": COL, "wk": COL, "wv": COL, "wo": ROW},
        "mlp": {"gate": COL, "up": COL, "down": ROW},
        "ln1": (None,),
        "ln2": (None,),
    }
    specs: Dict[str, Any] = {
        "embed": (None, None),
        "layers": [layer_spec for _ in range(cfg.n_layers)],
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = COL
    return specs


def check_tp_divisible(cfg: DecoderConfig, n: int) -> None:
    """The tensor-parallel axis size must divide the head, ff and (for an
    untied head) vocab dims; a tied vocabulary is replicated."""
    vocab_ok = cfg.tie_embeddings or cfg.vocab_size % n == 0
    if (cfg.n_heads % n or cfg.n_kv_heads % n or cfg.d_ff % n
            or not vocab_ok):
        raise ValueError(
            f"tensor-parallel axis size {n} must divide n_heads="
            f"{cfg.n_heads}, n_kv_heads={cfg.n_kv_heads}, d_ff="
            f"{cfg.d_ff} (and vocab_size={cfg.vocab_size} when "
            "lm_head is untied)")


def _slice(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    n, r = mesh.shape["model"], mesh.rank("model")
    if "model" not in spec or n == 1:
        return replicate(x, mesh)
    dim = spec.index("model")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).to(mesh.device).clone(
        memory_format=torch.contiguous_format)


def shard_params(params, cfg: DecoderConfig, mesh: Mesh):
    """This rank's slices of a float parameter tree, on the mesh's device
    (copies: the full tree can be freed after).  The int8 tree is served
    replicated only (``MESH_MODEL=1``): with model > 1 it raises, as
    ``Config.validate`` does."""
    n = mesh.shape["model"]

    def walk(tree, spec):
        if isinstance(tree, dict) and set(tree) == {"w", "s"} \
                and tree["w"].dtype == torch.int8:
            if n > 1:
                raise ValueError(
                    "LLM_WEIGHTS_DTYPE='int8' is single-chip serving: the "
                    "int8 tree is not sharded over a 'model' axis of size "
                    f"{n}; use MESH_MODEL=1 with it")
            return {k: replicate(v, mesh) for k, v in tree.items()}
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return _slice(tree, spec, mesh)

    return walk(params, decoder_param_specs(cfg))
