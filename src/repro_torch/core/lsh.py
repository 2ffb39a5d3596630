"""Hyperplane-based LSH with persisted hyperplanes (paper §III.B).

The hyperplanes are sampled once from the config seed with numpy's
PCG64 — the same generator and draw as the JAX package, so both derive
identical arrays — and *persisted* (checkpointed with the graph):
re-hashing any embedding at any later time is deterministic, which is
the property that makes incremental updates (Alg 3) and fault-tolerant
index rebuilds possible.  Hashing runs on ``device`` (the CUDA
``lsh_hash`` kernel on ``cuda``); codes come back to the host as
uint32 words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.lsh_hash.ops import codes_to_int, lsh_hash


class HyperplaneLSH:
    def __init__(self, dim: int, n_hyperplanes: int, seed: int = 0,
                 device=None):
        if n_hyperplanes < 1:
            raise ValueError("need >= 1 hyperplane")
        self.dim = dim
        self.k = n_hyperplanes
        self.seed = seed
        self.device = resolve_device(device)
        rng = np.random.Generator(np.random.PCG64(seed))
        # rows ~ N(0, I): rotation-invariant => Theorem 1 collision prob
        self._set_planes(rng.standard_normal(
            (dim, n_hyperplanes)).astype(np.float32))

    def _set_planes(self, planes: np.ndarray) -> None:
        self.hyperplanes = planes
        self._planes = torch.tensor(planes, device=self.device)

    # -- hashing ----------------------------------------------------------
    def hash_packed(self, vectors: np.ndarray) -> np.ndarray:
        """(n, d) -> (n, ceil(k/32)) uint32 packed sign codes."""
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}), got {v.shape}")
        codes = lsh_hash(torch.from_numpy(v).to(self.device), self._planes)
        return codes.cpu().numpy().view(np.uint32)

    def hash_ints(self, vectors: np.ndarray) -> np.ndarray:
        """(n, d) -> (n,) integer bucket keys (code as little-endian int).

        Integer keys sort identically to the bit codes; adjacent keys
        share long suffixes of hyperplane signs, which is the proximity
        order the merge step walks (paper: 'adjacent in Hamming space').
        """
        return codes_to_int(self.hash_packed(vectors), self.k)

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"dim": self.dim, "k": self.k, "seed": self.seed,
                "hyperplanes": self.hyperplanes}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "HyperplaneLSH":
        obj = cls.__new__(cls)
        obj.dim = int(state["dim"])
        obj.k = int(state["k"])
        obj.seed = int(state["seed"])
        obj.device = resolve_device(device)
        obj._set_planes(np.asarray(state["hyperplanes"], dtype=np.float32))
        return obj

    @staticmethod
    def collision_probability(theta: float) -> float:
        """Per-bit collision probability for sign-random-projection:
        the exact Goemans-Williamson result P = 1 - theta/pi."""
        return 1.0 - theta / np.pi
