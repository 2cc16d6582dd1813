"""Parameter trees: nested dicts and lists with tensor leaves.

The port keeps the JAX package's pytree layout (``models/llama.py``); these
helpers stand in for ``jax.tree.map`` and ``tree_flatten_with_path`` on
it.  Dicts and lists are the containers; anything else is a leaf (a spec
tuple of ``parallel/sharding.py`` too).  Leaves come in one fixed order
(dict insertion order, list order), and a leaf's key is its path joined by
'/' (``layers/0/attn/wq``), the key the native checkpoint's ``params.npz``
uses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    return list(flatten_with_paths(tree).values())


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined key path: leaf} in leaf order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}{k}/"))
    return out


def unflatten_like(template: Any, flat: Dict[str, Any],
                   prefix: str = "") -> Any:
    """A tree of ``template``'s structure whose leaves are ``flat``'s
    entries at the same key paths."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, list):
        return [unflatten_like(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    return flat[prefix[:-1]]
