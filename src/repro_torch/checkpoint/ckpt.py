"""Numpy-based tree checkpointing in the reference's format.

Counterpart of ``repro/checkpoint/ckpt.py``: a tree of tensors (params,
optimizer state, ``TrainState``) is flattened into one ``.npz`` whose keys
are the leaves' paths joined with ``::`` (dict keys by name, list indices
as digits, dataclass fields as ``.name`` — ``repro_torch.tree``), plus a
JSON sidecar with the step and the keys. Written atomically (temp file +
rename). The keys and dtypes are the reference's, so a checkpoint written
by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, map_with_path

_SEP = "::"


def _key(path) -> str:
    return _SEP.join(path) or "_root"


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: a bf16 leaf (the prefetch carry's blocks under
    # block_dtype="bf16") is stored as its exact float32 values
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.detach().cpu().numpy()


def save_checkpoint(directory: str, step: int, tree: Any,
                    name: str = "ckpt") -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = {_key(p): _to_numpy(leaf) for p, leaf in flatten_with_paths(tree)}
    path = checkpoint_path(directory, step, name)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    meta = {"step": step, "keys": sorted(arrays.keys())}
    with open(os.path.join(directory, f"{name}_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def checkpoint_path(directory: str, step: int, name: str = "ckpt") -> str:
    """The ONE definition of a checkpoint's on-disk location."""
    return os.path.join(directory, f"{name}_{step:08d}.npz")


def checkpoint_keys(directory: str, step: int, name: str = "ckpt") -> list:
    """The flattened leaf keys stored in a checkpoint."""
    with np.load(checkpoint_path(directory, step, name)) as data:
        return list(data.files)


def latest_step(directory: str, name: str = "ckpt") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"{re.escape(name)}_(\d+)\.npz$")
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := pat.match(fn))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, example_tree: Any,
                    name: str = "ckpt") -> Tuple[Any, int]:
    """Restore into the structure of ``example_tree``: each leaf gets the
    example leaf's shape, dtype and device. A stored array of another dtype
    is cast and the cast is asserted lossless (it round-trips exactly), so
    a checkpoint written under another dtype regime — an int64 step, say —
    fails loudly instead of shifting the run."""
    path = checkpoint_path(directory, step, name)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}

    def restore(p, leaf: torch.Tensor) -> torch.Tensor:
        key = _key(p)
        if key not in arrays:
            raise ValueError(
                f"checkpoint {path} has no leaf '{key}' (saved keys: "
                f"{sorted(arrays)}): it was written under a different "
                "state layout — restore into a matching example tree or "
                "migrate the checkpoint")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        want = _to_numpy(torch.empty(0, dtype=leaf.dtype)).dtype
        if arr.dtype != want:
            cast = arr.astype(want)
            if not np.array_equal(cast.astype(arr.dtype), arr,
                                  equal_nan=True):
                raise ValueError(
                    f"{key}: checkpoint dtype {arr.dtype} does not restore "
                    f"losslessly into {want} — the checkpoint was written "
                    "under a different dtype regime")
            arr = cast
        return torch.from_numpy(np.array(arr)).to(leaf.device, leaf.dtype)

    return map_with_path(restore, example_tree), step
