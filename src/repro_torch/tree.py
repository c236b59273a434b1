"""Nested containers of tensors — the port's pytrees.

Params, optimizer states and ``TrainState`` are dicts, lists/tuples and
dataclasses of tensors. Leaves come in JAX's flattening order (dict keys
sorted, sequences in order, dataclass fields in declaration order, ``None``
holding no leaf), so a leaf's path is the reference's checkpoint key: dict
keys give their names, sequence indices their digits, dataclass fields
``.name``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

import torch

Path = Tuple[str, ...]


def flatten_with_paths(tree: Any, prefix: Path = ()
                       ) -> Iterator[Tuple[Path, torch.Tensor]]:
    """Every (path, leaf) of ``tree`` in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, prefix + (str(i),))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from flatten_with_paths(getattr(tree, f.name),
                                          prefix + ("." + f.name,))
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__} at "
                        f"{'::'.join(prefix) or '_root'}")


def leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_with_path(fn: Callable[[Path, torch.Tensor], Any], tree: Any,
                  prefix: Path = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_with_path(fn, getattr(tree, f.name),
                                  prefix + ("." + f.name,))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    others = [dict(flatten_with_paths(r)) for r in rest]
    return map_with_path(
        lambda path, leaf: fn(leaf, *(o[path] for o in others)), tree)


def unflatten(tree: Any, flat: List[Any]) -> Any:
    """``flat`` (in leaf order) placed in the structure of ``tree``."""
    pos = {path: i for i, (path, _) in enumerate(flatten_with_paths(tree))}
    if len(pos) != len(flat):
        raise ValueError(f"{len(flat)} values for {len(pos)} leaves")
    return map_with_path(lambda path, _: flat[pos[path]], tree)
