"""Trees of tensors: the nested dicts and lists that hold parameters and
optimizer state, walked the way the reference's ``jax.tree`` walks them.

Dict keys are visited in sorted order, as JAX flattens a dict, so sums over
leaves run in the reference's order, and ``keystr`` names a leaf's path as
``jax.tree_util.keystr`` does (``['segments'][0]['blocks'][0]['mixer']['wq']``),
which is the key of the leaf in a checkpoint.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied to the leaves of ``tree`` and the matching leaves of
    ``rest``, which have ``tree``'s structure; the result has it too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Tree, path: str = "") -> Tree:
    """``fn(keystr path, leaf)`` for every leaf; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def tree_items(tree: Tree, path: str = "") -> Iterator[tuple[str, Any]]:
    """(keystr path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{path}[{i}]")
    else:
        yield path, tree


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]
