"""The few pytree operations the port needs, over nested dicts, named
tuples and ``None`` (the structures of the parameter, optimizer and train
states).  Dict keys are visited in sorted order and ``None`` holds no
leaf, as in ``jax.tree_util``; a named-tuple field's path part is
``".name"``, as JAX's ``GetAttrKey`` prints, so `distributed.sharding.
path_str` gives the JAX package's leaf names."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in JAX's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], prefix + (k,))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_flatten_with_path(v, prefix + ("." + name,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, prefix + ("." + n,))
                            for n, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves``, given in the
    order of `tree_leaves`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        return next(it)
    return build(tree)
