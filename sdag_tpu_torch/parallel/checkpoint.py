"""Parameter-tree and training-state checkpoints, in the port's own format.

Counterpart of ``sdag_tpu/parallel/checkpoint.py``, which uses orbax; the
port neither reads nor writes orbax.  A checkpoint is a directory:

- ``model.safetensors``: every tensor leaf as a *global* tensor
  (``models/safetensors_io.py``), named by its '/'-joined key path;
- ``tree.json``: the tree's skeleton (dicts and lists, a tensor leaf as
  its name, a number as itself), and the layout the leaves were split by
  (mesh shape and per-leaf specs, for reading only).

Leaves split over a mesh (a ``TrainState``'s ``layout``: Megatron slices
over ``model``, a pipeline's layer stacks over ``pipe``) are all-gathered
before rank 0 writes them, as orbax writes JAX's global arrays, so any
mesh can restore the checkpoint: restoring into a template re-slices each
leaf onto the template's layout and device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from sdag_tpu_torch.core.mesh import is_writer
from sdag_tpu_torch.models.safetensors_io import (SINGLE_FILE,
                                                  open_checkpoint,
                                                  save_safetensors)
from sdag_tpu_torch.parallel.collectives import all_gather_cat
from sdag_tpu_torch.utils.tree import flatten_with_paths

TREE = "tree.json"


def _spec_tree(tree, specs):
    """specs broadcast over ``tree`` (None where the tree has no spec)."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v, specs.get(k) if isinstance(specs, dict)
                              else None) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v, specs[i] if isinstance(specs, list) else None)
                for i, v in enumerate(tree)]
    return specs if isinstance(specs, tuple) else None


def _gather(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec or ()):
        if axis is not None and mesh.shape.get(axis, 1) > 1:
            x = all_gather_cat(x.contiguous(), mesh.group(axis), dim=dim)
    return x


def _slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec or ()):
        n = mesh.shape.get(axis, 1) if axis is not None else 1
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.rank(axis) * size, size)
    return x


def _walk(tree, specs, fn, prefix=""):
    """``fn(key path, leaf, spec)`` over the leaves, in a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, specs[i], fn, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree, specs)


def save_pytree(path: str, tree: Any, layout: Optional[dict] = None
                ) -> None:
    """Save a tree of tensors and numbers (overwrites).  ``layout``
    (``{"mesh", "specs"}``): the leaves are this rank's slices; they are
    gathered over the mesh (every rank must call this) and rank 0
    writes."""
    specs = _spec_tree(tree, layout["specs"] if layout else None)
    mesh = layout["mesh"] if layout else None
    tensors = {}

    def put(name, leaf, spec):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            tensors[name] = _gather(t, spec, mesh) if mesh else t
            return name
        return leaf

    skeleton = _walk(tree, specs, put)
    if is_writer():
        os.makedirs(path, exist_ok=True)
        save_safetensors(tensors, os.path.join(path, SINGLE_FILE))
        meta = {"tree": skeleton,
                "mesh": dict(mesh.shape) if mesh else None,
                "specs": {k: list(s) for k, s in
                          flatten_with_paths(specs).items()
                          if s is not None}}
        with open(os.path.join(path, TREE), "w") as fh:
            json.dump(meta, fh, indent=1)
    if dist.is_initialized():
        dist.barrier()


def load_pytree(path: str, target: Optional[Any] = None,
                layout: Optional[dict] = None, device="cpu") -> Any:
    """Restore a tree.  Without ``target``: global tensors on ``device``.
    With ``target`` (a tree of the same structure): each tensor is
    re-sliced by ``layout`` (the target's, None = whole) and placed on the
    target leaf's device and dtype, keeping its ``requires_grad``."""
    with open(os.path.join(path, TREE)) as fh:
        skeleton = json.load(fh)["tree"]
    with open_checkpoint(path, device="cpu") as ckpt:
        return _load(ckpt, skeleton, target, layout, device)


def _load(ckpt, skeleton, target, layout, device):
    if target is None:
        return _walk(skeleton, _spec_tree(skeleton, None),
                     lambda _n, leaf, _s: ckpt[leaf].to(device)
                     if isinstance(leaf, str) else leaf)
    specs = _spec_tree(target, layout["specs"] if layout else None)
    mesh = layout["mesh"] if layout else None

    def place(name, leaf, spec):
        stored = _lookup(skeleton, name)
        if not isinstance(leaf, torch.Tensor):
            return stored
        x = ckpt[stored]
        x = _slice(x, spec, mesh) if mesh else x
        if tuple(x.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint slice {tuple(x.shape)} "
                             f"!= template {tuple(leaf.shape)}")
        return x.to(device=leaf.device, dtype=leaf.dtype).clone(
            memory_format=torch.contiguous_format).requires_grad_(
                leaf.requires_grad)

    return _walk(target, specs, place)


def _lookup(tree, name: str):
    for part in name.split("/") if name else ():
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _state_layout(layout):
    """A TrainState's layout over its saved tree: the optimizer moments
    are split like the parameters."""
    if layout is None:
        return None
    specs = layout["specs"]
    return dict(layout, specs={"params": specs,
                               "opt_state": {"mu": specs, "nu": specs}})


def save_train_state(path: str, state) -> None:
    """Persist a ``parallel.train.TrainState`` (params + optimizer +
    step), gathered over its layout's mesh."""
    save_pytree(path, {"params": state.params,
                       "opt_state": state.opt_state, "step": state.step},
                _state_layout(state.layout))


def restore_train_state(path: str, state):
    """Restore into an existing ``TrainState`` template: every leaf sliced
    onto the template's layout and placed like the template's leaf."""
    from sdag_tpu_torch.parallel.train import TrainState
    restored = load_pytree(
        path, target={"params": state.params, "opt_state": state.opt_state,
                      "step": state.step},
        layout=_state_layout(state.layout))
    opt_state = dict(restored["opt_state"],
                     count=int(restored["opt_state"]["count"]))
    return TrainState(params=restored["params"], opt_state=opt_state,
                      step=int(restored["step"]), layout=state.layout)
