"""Nested dicts and lists of tensors (the port's parameter, gradient and
optimizer trees): leaves with their paths, a map over leaves, and the
reference's stacked-leaf key of a path.

The reference stacks the layers on a leading axis (``params/layers/attn/wq``
is ``[L, ...]``, and so are ``dense_layers``, ``enc_layers`` and
``dec_layers``); the port keeps a list (``params/layers/<i>/attn/wq``).
``stack_key`` drops the layer index, so every per-layer leaf finds the
reference leaf it is a slice of.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]

# the parameter lists the reference stacks on a leading layer axis
STACKED = ("layers", "dense_layers", "enc_layers", "dec_layers")


def leaves_with_paths(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) in a fixed order: dict keys as stored, list indices
    ascending. A leaf is anything but a dict, list or tuple."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same positions of ``rest``
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def stack_key(path: Path) -> str:
    """The reference's key of the stacked leaf a per-layer leaf belongs to:
    ``("layers", 3, "attn", "wq")`` -> ``"layers/attn/wq"`` (the index after
    any of ``STACKED`` dropped)."""
    parts = [str(p) for i, p in enumerate(path)
             if not (isinstance(p, int) and i > 0 and path[i - 1] in STACKED)]
    return "/".join(parts)


def path_key(path: Path) -> str:
    """``("layers", 3, "attn", "wq")`` -> ``"layers/3/attn/wq"``."""
    return "/".join(str(p) for p in path)
