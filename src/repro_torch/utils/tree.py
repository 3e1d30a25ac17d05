"""Nested-dict tree utilities over tensors (the port's pytrees).

Trees are nested ``dict``s whose leaves are tensors (or any non-dict value).
Every traversal visits keys in sorted order, which is the leaf order of
``jax.tree.leaves`` on the same dict, so sums over leaves and leaf lists
line up with the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch


def _is_node(x: Any) -> bool:
    # dicts and tensors first: an ABC check against Mapping costs ~10x more
    if isinstance(x, dict):
        return True
    if x is None or isinstance(x, torch.Tensor):
        return False
    return isinstance(x, Mapping)


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``('a/b/c', leaf)`` pairs in sorted-key order."""
    if _is_node(tree):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in sorted-key order (no key paths built)."""
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(tree: Any, out: List[Any]) -> None:
    if _is_node(tree):
        for k in sorted(tree):
            _collect(tree[k], out)
    else:
        out.append(tree)


def tree_leaves_like(like: Any, tree: Any) -> List[Any]:
    """The values of ``tree`` at ``like``'s leaf positions, in leaf order:
    a key of ``like`` missing from ``tree`` raises KeyError, as
    :func:`tree_map` over the two does."""
    out: List[Any] = []
    _collect_like(like, tree, out)
    return out


def _collect_like(like: Any, tree: Any, out: List[Any]) -> None:
    if _is_node(like):
        for k in sorted(like):
            _collect_like(like[k], tree[k], out)
    else:
        out.append(tree)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` and same-structured ``rest``."""
    if _is_node(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_map_with_path_str(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """tree_map where ``fn`` receives a '/'-joined key path string."""
    if _is_node(tree):
        return {
            k: tree_map_with_path_str(fn, tree[k], f"{prefix}/{k}" if prefix else str(k))
            for k in sorted(tree)
        }
    return fn(prefix, tree)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order (the
    inverse of :func:`tree_leaves`)."""
    return _build(like, iter(leaves))


def _build(node: Any, it: Iterator[Any]) -> Any:
    # a module-level recursion: a self-referencing closure would form a
    # reference cycle that keeps the leaves alive until the garbage collector runs
    if _is_node(node):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def tree_unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """Split a tree of n-tuples into n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def tree_size(tree: Any) -> int:
    """Total number of elements."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes, from each leaf's own dtype."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def host_array(x: Any) -> np.ndarray:
    """``x`` as a numpy array: a host array as it is, a tensor on any device
    brought to the host (sharing its storage when it is there already)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def flatten_dict(d: Mapping[str, Any], prefix: str = "", sep: str = "/") -> Dict[str, Any]:
    """Flatten a nested dict into ``{'a/b/c': leaf}`` (an empty subtree
    leaves no key)."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if _is_node(v):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_dict(d: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """The nested dict of :func:`flatten_dict`'s ``path/to/leaf`` keys."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split(sep)
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def tree_l2_norm(tree: Any) -> torch.Tensor:
    """The f32 L2 norm of all leaves together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)))
