"""Parameter and state trees: nested dicts whose leaves are tensors or
``QuantizedTensor``s.

The reference's trees are JAX pytrees of dicts, which JAX flattens in sorted
key order and names by ``jax.tree_util.keystr`` (``['params']['embed']``).
These helpers walk a tree in that order and name its leaves the same way, so
that the optimizer sums its norms, the checkpoint store keys its arrays and
the GGML export writes its tensors as the reference does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def items(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's flattening order: a dict's keys sorted,
    a ``QuantizedTensor`` one leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in items(tree[k], (*path, k))]
    return [(path, tree)]


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys: ``['a'][1]``."""
    return "".join(f"[{k!r}]" for k in path)


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same keys of
    ``rest``, in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(like: Any, values: list) -> Any:
    """A tree of ``like``'s structure holding ``values`` in ``items``'
    order."""
    return _fill(like, iter(values))


def _fill(t: Any, it) -> Any:
    # a module-level recursion: a recursive closure would hold itself and
    # ``values`` in a reference cycle until the next collection (a train
    # step's gradients, 12.9 GB at llama3.2-3b)
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    return next(it)
