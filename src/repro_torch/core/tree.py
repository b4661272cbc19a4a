"""Nested dicts and lists of tensors ("trees"), as the port keeps
parameters, optimizer state and checkpoints: leaves in a fixed order
(dict keys sorted, as ``jax.tree`` orders them; lists in order) and a map
over trees of one structure."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in order (None counts as an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path (``layers.3.attn.wq``), in the order of `leaves`."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in paths(v, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure,
    in the order of `leaves`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like, values):
    """A tree of ``like``'s structure whose leaves are ``values`` (in the
    order of `leaves`)."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return None if t is None else next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
