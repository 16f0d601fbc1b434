"""Param trees of the port: nested dicts and lists with tensor leaves."""
from __future__ import annotations


def map_with_path(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of a tree of dicts, lists and
    tuples (tuples come back as lists); paths join keys and list indices
    with '/', e.g. ``layers/3/attn/wq``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def leaves_with_path(tree, path: str = ""):
    """(path, leaf) of every leaf, in ``map_with_path``'s order and path
    form."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def get_path(tree, path: str):
    """The node at ``path`` (as ``map_with_path`` writes it)."""
    for key in path.split("/") if path else ():
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree
