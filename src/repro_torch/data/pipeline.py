"""The synthetic token stream of the transformer examples (counterpart of
``repro/data/pipeline.py``, in numpy as the reference's is, and bit for bit
the same batches).

No network access, so LM training runs on a synthetic Zipf-distributed
token stream with planted bigram structure: token t+1 is, with probability
``coherence``, a deterministic function of token t (so a model can learn
something measurable and the loss curve means something), otherwise a
fresh Zipf draw. Deterministic per (seed, step), infinite, O(1) memory.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    coherence: float = 0.7

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, targets), both (batch, seq_len) int32."""
        rng = np.random.default_rng((self.seed << 20) + step)
        n = self.batch * (self.seq_len + 1)
        zipf = rng.zipf(self.zipf_a, size=n).astype(np.int64)
        base = np.minimum(zipf, self.vocab_size - 1)
        toks = np.empty(n, np.int64)
        toks[0] = base[0]
        # planted bigram: x_{t+1} = (a*x_t + c) mod V with prob `coherence`
        follow = rng.random(n) < self.coherence
        a = 6364136223846793005 % self.vocab_size
        c = 1442695040888963407 % self.vocab_size
        for i in range(1, n):
            toks[i] = (a * toks[i - 1] + c) % self.vocab_size \
                if follow[i] else base[i]
        toks = toks.reshape(self.batch, self.seq_len + 1)
        return (toks[:, :-1].astype(np.int32),
                toks[:, 1:].astype(np.int32))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_lm_batches(vocab_size: int, batch: int, seq_len: int,
                    steps: int, seed: int = 0):
    ts = TokenStream(vocab_size, batch, seq_len, seed)
    for s in range(steps):
        yield ts.batch_at(s)


def shard_batch_for_mesh(mesh, tokens: np.ndarray, targets: np.ndarray,
                         batch_axes=("pod", "data")):
    """This rank's rows of a host batch on the mesh's device: the batch
    split over the DP axes among ``batch_axes`` (pod outer, data inner,
    the reference's ``P(("pod", "data"), None)``), replicated over the
    rest. A batch the DP size does not divide raises ``ValueError``, as
    the reference's ``jax.device_put`` does."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    b = tokens.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over the "
                         f"{n} ranks of the axes {axes}")
    rows = slice(idx * (b // n), (idx + 1) * (b // n))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows])).to(
        mesh.device)
    return put(tokens), put(targets)
