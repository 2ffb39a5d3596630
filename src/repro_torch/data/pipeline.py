"""Training-data pipeline: deterministic sharded synthetic batches.

Every batch is a pure function of ``(seed, step, shard)``: numpy's
``PCG64(SeedSequence([seed, step, shard]))``, the JAX package's own
draw, so the port's batches are bitwise the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def synthetic_lm_batches(vocab_size: int, batch: int, seq_len: int,
                         seed: int = 0, shard: int = 0,
                         n_shards: int = 1
                         ) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns step -> {tokens, labels} (int32 numpy) for this worker's
    shard."""
    if batch % n_shards != 0:
        raise ValueError(f"batch {batch} not divisible by shards {n_shards}")
    local = batch // n_shards

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence([seed, step, shard])))
        toks = rng.integers(4, vocab_size, size=(local, seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make
