"""Training step: next-token LM loss through the SDAG mask, AdamW.

Counterpart of ``sdag_tpu/parallel/train.py``: fine-tune the generator
under document isolation, so it is trained with the attention structure it
serves with.  The loss runs the differentiable dense-mask attention
(``attn_impl="xla"``, as the JAX package trains); kernel K1 has no
backward, so the trained weights reach the kernels when they are served.

A step over a ``Mesh`` (``core/mesh.py``): every rank receives the global
batch and takes its block of rows along ``data``; parameters are
Megatron-sliced over ``model`` (``parallel/sharding.py``), whose layer
collectives are autograd Functions (``parallel/collectives.py``).  The loss
is the global weighted sum over the global weight (rows weigh 0.1 on the
prompt and 1.0 on the answer, so a mean of rank means would be wrong), and
gradients are summed over ``data``.  Parameters, optimizer moments and
gradients are updated in place: a step returns the same tensors in a new
``TrainState`` (the JAX step donates its input state).

The optimizer is ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay on every leaf) on torch's foreach AdamW
(``torch.optim.adamw.adamw(foreach=True)``); the learning rate at update
``count`` (from 0) is the schedule's value at ``count``, as optax reads it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from sdag_tpu_torch.core.mesh import Mesh
from sdag_tpu_torch.models.llama import DecoderConfig, prefill
from sdag_tpu_torch.parallel.collectives import (all_reduce_,
                                                 all_reduce_grads_)
from sdag_tpu_torch.parallel.sharding import decoder_param_specs, shard_params
from sdag_tpu_torch.utils.tree import tree_leaves, tree_map

BATCH_KEYS = ("input_ids", "targets", "doc_id", "nbr_bits", "sys_user_len",
              "valid_len", "loss_mask")


class TrainState(NamedTuple):
    """params, optimizer state and the count of steps taken.  ``layout``:
    how the leaves are split over a mesh (``{"mesh": Mesh, "specs": spec
    tree}``, the JAX arrays' shardings), None when they are whole on one
    device; a checkpoint gathers and re-slices by it
    (``parallel/checkpoint.py``)."""
    params: Any
    opt_state: Any
    step: int
    layout: Any = None


def lm_loss_terms(params, cfg: DecoderConfig, batch: Dict[str, Any],
                  attn_impl: str = "xla", tp_group=None):
    """(weighted next-token cross-entropy summed over the batch, the sum
    of the loss weights): the parts of ``lm_loss`` a data-parallel step
    sums over its ranks."""
    logits, _ = prefill(
        params, cfg, batch["input_ids"], doc_id=batch["doc_id"],
        nbr_bits=batch["nbr_bits"], sys_user_len=batch["sys_user_len"],
        valid_len=batch["valid_len"], with_cache=False, tp_group=tp_group,
        attn_impl=attn_impl)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
    mask = batch["loss_mask"].float()
    return -(tgt * mask).sum(), mask.sum()


def lm_loss(params, cfg: DecoderConfig, batch: Dict[str, Any],
            attn_impl: str = "xla", tp_group=None) -> torch.Tensor:
    """Mean next-token cross-entropy over loss-masked positions, with the
    SDAG block mask applied at the prefill."""
    total, count = lm_loss_terms(params, cfg, batch, attn_impl, tp_group)
    return total / count.clamp_min(1.0)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over counts 0..warmup_steps, then cosine decay to
    ``end_value`` at ``decay_steps`` (which includes the warmup); counts
    from 0, so with ``init_value`` 0 the first update has lr 0.  Computed
    in float32, as optax computes it."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={cos_steps}.")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = f32(1) - f32(c) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                             / f32(cos_steps)))
        decayed = f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, weight_decay)`` on a
    parameter tree, in place.  ``learning_rate``: a float or a schedule
    (count -> float).  ``init`` gives the state ``{"count", "mu", "nu"}``
    (optax's ScaleByAdamState); ``update_`` applies one update with lr =
    schedule(count), then count + 1.  optax adds ``wd * p`` to the Adam
    direction and scales by -lr; torch's AdamW decays p by ``lr * wd``
    first: equal in exact arithmetic."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, grads, opt_state: Dict[str, Any], params
                ) -> Dict[str, Any]:
        """One update of ``params`` (a tree, or its leaves) by ``grads``
        (leaves in the same order); returns the state with count + 1."""
        from torch.optim.adamw import adamw
        ps = tree_leaves(params)
        gs = list(grads) if isinstance(grads, (list, tuple)) \
            else tree_leaves(grads)
        count = int(opt_state["count"])
        steps = [torch.tensor(float(count)) for _ in ps]
        adamw(ps, gs, tree_leaves(opt_state["mu"]),
              tree_leaves(opt_state["nu"]), [], steps, foreach=True,
              amsgrad=False, beta1=self.b1, beta2=self.b2,
              lr=self.lr_at(count), weight_decay=self.weight_decay,
              eps=self.eps, maximize=False)
        return dict(opt_state, count=count + 1)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr, weight_decay=weight_decay)


def _trainable(tree):
    """Leaves as fresh float tensors that require grad (the caller's
    tensors are never trained in place)."""
    return tree_map(lambda x: x.detach().clone().requires_grad_(True), tree)


def _make_init_state(cfg: DecoderConfig, mesh: Mesh, optimizer: AdamW):
    def init_state(params) -> TrainState:
        params = _trainable(shard_params(params, cfg, mesh))
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0, layout={"mesh": mesh,
                                          "specs": decoder_param_specs(cfg)})
    return init_state


def local_batch(batch: Dict[str, Any], mesh: Mesh, axis: str = "data"
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of the global batch's rows along ``axis``, on the
    mesh's device (numpy arrays or tensors in)."""
    n, r = mesh.shape.get(axis, 1), mesh.coords.get(axis, 0)
    out = {}
    for k in BATCH_KEYS:
        t = torch.as_tensor(batch[k])
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not divide "
                             f"the {axis} axis size {n}")
        rows = t.shape[0] // n
        out[k] = t[r * rows:(r + 1) * rows].to(mesh.device)
    return out


def _train_step(cfg: DecoderConfig, mesh: Mesh, optimizer: AdamW,
                attn_impl: str, state: TrainState, batch):
    """One step on this rank's rows (already on the device)."""
    data = mesh.group("data")
    total, count = lm_loss_terms(state.params, cfg, batch, attn_impl,
                                 tp_group=mesh.group("model"))
    count = all_reduce_(count.detach().clone(), data)
    loss = total / count.clamp_min(1.0)
    leaves = tree_leaves(state.params)
    grads = list(torch.autograd.grad(loss, leaves))
    all_reduce_grads_(grads, data)
    opt_state = optimizer.update_(grads, state.opt_state, leaves)
    loss = all_reduce_(loss.detach().clone(), data)
    return TrainState(state.params, opt_state, state.step + 1,
                      state.layout), loss


def make_sharded_train_step(cfg: DecoderConfig, mesh: Mesh,
                            optimizer: Optional[AdamW] = None,
                            attn_impl: str = "xla"):
    """Returns (init_state_fn, step_fn) over the mesh: ``init_state(params)``
    slices (copies) the plain tree onto this rank; ``step(state, batch)``
    takes the global batch and returns (state, loss)."""
    optimizer = optimizer or make_optimizer()
    init_state = _make_init_state(cfg, mesh, optimizer)

    def step_fn(state: TrainState, batch):
        return _train_step(cfg, mesh, optimizer, attn_impl, state,
                           local_batch(batch, mesh))

    return init_state, step_fn


def make_sharded_train_scan(cfg: DecoderConfig, mesh: Mesh,
                            optimizer: Optional[AdamW] = None,
                            attn_impl: str = "xla",
                            preprocess: Optional[Callable] = None):
    """:func:`make_sharded_train_step` over a stack: ``scan_fn(state,
    stacked)`` uploads a [S, B, ...] dict of S batches once and runs S
    steps, returning (state, losses [S]) with one host read.
    ``preprocess`` maps each step's batch first (``train_qa``'s
    ``decompress_batch``: the wire dtypes back to int32 / f32)."""
    optimizer = optimizer or make_optimizer()
    init_state = _make_init_state(cfg, mesh, optimizer)

    def scan_fn(state: TrainState, stacked):
        up = {k: torch.as_tensor(v).to(mesh.device)
              for k, v in stacked.items()}
        losses = []
        for i in range(next(iter(up.values())).shape[0]):
            batch = {k: v[i] for k, v in up.items()}
            if preprocess is not None:
                batch = preprocess(batch)
            state, loss = _train_step(cfg, mesh, optimizer, attn_impl,
                                      state, local_batch(batch, mesh))
            losses.append(loss)
        return state, torch.stack(losses)

    return init_state, scan_fn


def make_dummy_batch(cfg: DecoderConfig, batch: int, seq_len: int,
                     num_docs: int = 2) -> Dict[str, torch.Tensor]:
    """Tiny synthetic SDAG-masked LM batch for dry runs and tests (the JAX
    function's arrays, as CPU tensors; a step moves them)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.vocab_size - 1,
                       size=(batch, seq_len)).astype(np.int32)
    targets = np.roll(ids, -1, axis=1)
    doc_id = np.full((batch, seq_len), -1, np.int32)
    sys_len = seq_len // 4
    span = max(1, (seq_len // 2) // max(num_docs, 1))
    for d in range(num_docs):
        s = sys_len + d * span
        doc_id[:, s:s + span - 1] = d
    loss_mask = np.ones((batch, seq_len), np.float32)
    loss_mask[:, -1] = 0.0
    return {
        "input_ids": torch.from_numpy(ids),
        "targets": torch.from_numpy(targets),
        "doc_id": torch.from_numpy(doc_id),
        "nbr_bits": torch.zeros((batch, seq_len), dtype=torch.int32),
        "sys_user_len": torch.full((batch,), sys_len, dtype=torch.int32),
        "valid_len": torch.full((batch,), seq_len, dtype=torch.int32),
        "loss_mask": torch.from_numpy(loss_mask),
    }
