"""Parameter trees of the port: nested dicts and lists of tensors, with
None for a leaf that is absent (a frozen leaf's optimizer moments). Any
other object, a tuple included, is a leaf.

Paths are the JAX package's: '/'-joined dict keys and list indices, dict
keys visited in sorted order as `jax.tree_util` visits them, so that a
flat npz of one framework is a flat npz of the other
(train/checkpoints.py).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def _items(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        return ((str(k), node[k]) for k in sorted(node))
    return ((str(i), v) for i, v in enumerate(node))


def leaves_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the JAX package's order; None leaves skipped."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, (dict, list)):
            for k, v in _items(node):
                walk(v, f"{path}/{k}" if path else k)
        else:
            out.append((prefix + path, node))

    walk(tree, "")
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree: Tree,
                  *rest: Tree) -> Tree:
    """A tree of fn(path, leaf, *leaves of `rest` at that path), of `tree`'s
    structure; a None leaf of `tree` stays None."""

    def walk(node, others, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, [o[k] for o in others],
                            f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, [o[i] for o in others],
                         f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        return fn(path, node, *others)

    return walk(tree, list(rest), "")


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """map_with_path without the path."""
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
