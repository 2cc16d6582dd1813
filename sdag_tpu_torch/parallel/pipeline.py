"""Pipeline parallelism: GPipe-style microbatched training over a 'pipe'
mesh axis.

Counterpart of ``sdag_tpu/parallel/pipeline.py``.  The decoder's layers are
split into contiguous stages, one per rank along 'pipe' (``core/mesh.py``
``make_pipe_mesh``); each rank holds only its stage's layer stack.  The
JAX package runs one ``lax.scan`` of n_micro + n_stages - 1 ticks (stage
s works on microbatch t - s) and differentiates through ``ppermute``.
Here each rank runs the torch idiom of the same schedule: all forwards,
microbatch by microbatch (stage 0 embeds, a later stage receives its
activation from the stage before, the last stage takes the loss), then all
backwards in reverse microbatch order.  Activations and their gradients
move through ``send_to`` / ``recv_from`` (``parallel/collectives.py``),
autograd Functions whose backward carries the gradient the other way, so
one backward per microbatch and rank runs the pipelined backward.

The embedding, the final norm and a tied or untied head are replicated
(the JAX ``shard_map``'s ``P()`` inputs), so their gradients are summed
over 'pipe' after the backward: a tied embedding takes its gather gradient
on stage 0 and its unembed gradient on the last stage.  With ``tp_axis``
each stage's layers are also Megatron-split over that axis (heads and
d_ff; the layer collectives are autograd Functions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from sdag_tpu_torch.core.mesh import Mesh
from sdag_tpu_torch.models.llama import (DecoderConfig, _embed_rows,
                                         layer_forward, layer_mask_plan,
                                         positions_from_doc_id)
from sdag_tpu_torch.ops.norm import add_rms_norm
from sdag_tpu_torch.parallel.checkpoint import _slice
from sdag_tpu_torch.parallel.collectives import (all_reduce_,
                                                 all_reduce_grads_,
                                                 recv_from, send_to)
from sdag_tpu_torch.parallel.train import (BATCH_KEYS, AdamW, TrainState,
                                           make_optimizer)
from sdag_tpu_torch.utils.tree import flatten_with_paths, tree_map

REPLICATED = ("embed", "final_norm", "lm_head")


def stack_layer_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """[{layer0}, {layer1}, ...] -> one tree with a leading layer axis."""
    layers = params["layers"]
    stacked = tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": stacked}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def unstack_layer_params(stacked: Dict[str, Any]) -> Dict[str, Any]:
    """The plain (list-of-layers) tree of a whole stacked tree (a
    checkpoint's, gathered over 'pipe')."""
    n = stacked["layers"]["ln1"].shape[0]
    out = {"embed": stacked["embed"],
           "layers": [tree_map(lambda x: x[i], stacked["layers"])
                      for i in range(n)],
           "final_norm": stacked["final_norm"]}
    if "lm_head" in stacked:
        out["lm_head"] = stacked["lm_head"]
    return out


def stacked_layer_specs(axis: str = "pipe",
                        tp_axis: Optional[str] = None) -> Dict[str, Any]:
    """Specs of the stacked layer tree: the layer axis over ``axis``; with
    tp_axis, Megatron column/row splits over it (heads and d_ff)."""
    t = tp_axis
    return {
        "attn": {"wq": (axis, None, t), "wk": (axis, None, t),
                 "wv": (axis, None, t), "wo": (axis, t, None)},
        "mlp": {"gate": (axis, None, t), "up": (axis, None, t),
                "down": (axis, t, None)},
        "ln1": (axis, None), "ln2": (axis, None),
    }


def stacked_param_specs(stacked: Dict[str, Any], axis: str = "pipe",
                        tp_axis: Optional[str] = None) -> Dict[str, Any]:
    """Specs of a whole stacked tree: layer stacks split, the rest
    replicated."""
    specs = {k: (None,) * stacked[k].dim() for k in REPLICATED
             if k in stacked}
    specs["layers"] = stacked_layer_specs(axis, tp_axis)
    return specs


def shard_stacked_params(stacked: Dict[str, Any], mesh: Mesh,
                         axis: str = "pipe",
                         tp_axis: Optional[str] = None) -> Dict[str, Any]:
    """This rank's copy of a stacked tree on the mesh's device: its
    stage's layers (and its tensor slices over tp_axis); embed, norm and
    head whole."""
    specs = stacked_param_specs(stacked, axis, tp_axis)
    return {k: tree_map(lambda x, s: _slice(x, s, mesh).to(mesh.device)
                        .clone(memory_format=torch.contiguous_format),
                        v, specs[k])
            for k, v in stacked.items()}


def make_pp_train_step(cfg: DecoderConfig, mesh: Mesh, n_micro: int,
                       optimizer: Optional[AdamW] = None,
                       attn_impl: str = "xla", axis: str = "pipe",
                       tp_axis: Optional[str] = None):
    """Returns (init_state_fn, step_fn, loss_fn) for pipeline-parallel
    training.

    init_state_fn takes the *plain* (list-of-layers) param tree and returns
    a TrainState with this rank's stage-stacked params.  step_fn(state,
    batch) and loss_fn(stacked, batch) take the global batch on every
    rank; both return the loss on every rank."""
    optimizer = optimizer or make_optimizer()
    n_stages = mesh.shape[axis]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{axis} axis size {n_stages} must divide "
                         f"n_layers={cfg.n_layers}")
    if tp_axis is not None:
        tp = mesh.shape[tp_axis]
        if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp:
            raise ValueError(
                f"tp={tp} must divide n_heads={cfg.n_heads}, "
                f"n_kv_heads={cfg.n_kv_heads}, and d_ff={cfg.d_ff}")
    stage, pipe = mesh.rank(axis), mesh.group(axis)
    tp_group = mesh.group(tp_axis) if tp_axis is not None else None
    last = stage == n_stages - 1
    prev_rank = dist.get_global_rank(pipe, stage - 1) if stage else None
    next_rank = None if last else dist.get_global_rank(pipe, stage + 1)

    def forward(stacked, batch) -> Tuple[list, torch.Tensor]:
        """All forwards of this rank's stage: (one terminal a microbatch,
        to run the backward from; the stage's share of the loss)."""
        B = batch["input_ids"].shape[0]
        if B % n_micro:
            raise ValueError(f"n_micro={n_micro} must divide batch {B}")
        batch = {k: torch.as_tensor(batch[k]).to(mesh.device)
                 for k in BATCH_KEYS}
        mbsz, L = B // n_micro, batch["input_ids"].shape[1]
        # the global weight: every stage holds the batch, so no collective
        count = batch["loss_mask"].float().sum().clamp_min(1.0)
        head = stacked.get("lm_head")
        n_local = stacked["layers"]["ln1"].shape[0]
        terminals, total = [], torch.zeros((), device=mesh.device)
        for m in range(n_micro):
            d = {k: v[m * mbsz:(m + 1) * mbsz] for k, v in batch.items()}
            meta = (d["doc_id"], d["nbr_bits"], d["sys_user_len"],
                    d["valid_len"])
            positions = positions_from_doc_id(d["doc_id"])
            plan = layer_mask_plan(*meta, attn_impl=attn_impl)
            if stage == 0:
                x = _embed_rows(stacked["embed"], d["input_ids"], cfg.dtype)
            else:
                x = recv_from((mbsz, L, cfg.d_model), cfg.dtype,
                              mesh.device, pipe, prev_rank)
            pending = None   # a layer's MLP output, added in the next norm
            for i in range(n_local):
                x, pending, _ = layer_forward(
                    tree_map(lambda t: t[i], stacked["layers"]), cfg, x,
                    positions, *meta, mask_plan=plan, tp_group=tp_group,
                    attn_impl=attn_impl, residual=pending)
            if not last:
                terminals.append(send_to(x + pending, pipe, next_rank))
                continue
            _, xn = add_rms_norm(x, pending, stacked["final_norm"],
                                 cfg.norm_eps)
            w = stacked["embed"].T if head is None else head
            logp = torch.log_softmax((xn @ w).float(), dim=-1)
            tgt = logp.gather(-1, d["targets"].long()[..., None])[..., 0]
            term = -(tgt * d["loss_mask"].float()).sum() / count
            terminals.append(term)
            total = total + term.detach()
        return terminals, total

    def pp_loss(stacked, batch) -> torch.Tensor:
        with torch.no_grad():
            _, total = forward(stacked, batch)
        return all_reduce_(total, pipe)

    def init_state(params) -> TrainState:
        stacked = stack_layer_params(params)
        local = shard_stacked_params(stacked, mesh, axis, tp_axis)
        local = tree_map(lambda x: x.requires_grad_(True), local)
        return TrainState(
            params=local, opt_state=optimizer.init(local), step=0,
            layout={"mesh": mesh,
                    "specs": stacked_param_specs(stacked, axis, tp_axis)})

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        terminals, total = forward(state.params, batch)
        for term in reversed(terminals):
            torch.autograd.backward(term)
        flat = flatten_with_paths(state.params)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in flat.items()}
        all_reduce_grads_([g for k, g in grads.items() if k in REPLICATED],
                          pipe)
        opt_state = optimizer.update_(list(grads.values()), state.opt_state,
                                      list(flat.values()))
        for p in flat.values():
            p.grad = None
        return TrainState(state.params, opt_state, state.step + 1,
                          state.layout), all_reduce_(total, pipe)

    return init_state, step_fn, pp_loss
