"""Configurations: the EraRAG system config and the LM family.

``EraRAGConfig`` takes every field name of the JAX package's dataclass,
because snapshots carry the config as a plain dict (``EraGraph.
state_dict()["cfg"]``) and ``EraRAG.from_state`` rebuilds it with
``EraRAGConfig(**cfg)``, validated identically.

``ShapeSpec``, ``ArchConfig``, ``MoEConfig``, ``LMConfig``,
``GNNConfig`` and ``RecSysConfig`` carry every field of the JAX
package's classes, with its ``reduced()``, ``param_count()`` and
``to_json()``, so a config converts field by field.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a component raises when asked for a subsystem this
    package does not serve yet; ``item`` names its ROADMAP entry."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})")


@dataclass(frozen=True)
class EraRAGConfig:
    """Hyper-parameters of the paper's technique (§III)."""

    n_hyperplanes: int = 12          # k: bits per hash code
    s_min: int = 4                   # lower segment-size bound
    s_max: int = 12                  # upper segment-size bound
    max_layers: int = 4              # L
    embed_dim: int = 256             # d
    chunk_tokens: int = 128          # tokenizer window per chunk
    top_k: int = 8                   # retrieval size
    token_budget: int = 2048         # T
    seed: int = 0                    # hyperplane PRNG seed (persisted)
    retrieval_bias_p: float = 0.5    # adaptive search p in [0, 1]
    summary_max_tokens: int = 96
    # vector-index sharding: 1 = single-buffer store, >1 = hash-routed
    # shards, 0 = one per device
    index_shards: int = 1
    collective_query: bool = True
    # index lifecycle (live resharding triggers; 0.0 disables)
    reshard_skew_threshold: float = 0.0
    reshard_tombstone_threshold: float = 0.0
    reshard_min_rows: int = 256
    reshard_max_shards: int = 64
    reshard_growth_factor: int = 2
    # two-stage quantized retrieval (coarse sign-bit scan + rescore)
    quantized_scan: bool = False
    coarse_mult: int = 4
    scan_bits: int = 64
    # semantic query cache in front of retrieval
    query_cache: bool = False
    query_cache_size: int = 1024
    query_cache_threshold: float = 1.0
    # the JAX package's serial-vs-batched summarizer switch; kept so
    # its snapshots' cfg dicts load.  The port always batches (its only
    # summarizer, the extractive one, gives the same nodes either way).
    batch_summaries: bool = True
    # content-keyed summary cache size (0 disables the cache)
    summary_cache_size: int = 512
    # streaming ingestion service quanta
    ingest_max_pending_docs: int = 1024
    ingest_docs_per_tick: int = 8
    ingest_embed_batch: int = 64
    ingest_max_pending_ops: int = 4096
    # observability: counters are always live; obs_trace also records
    # nested spans on the EraRAG's Tracer (bounded at obs_max_spans)
    obs_trace: bool = False
    obs_max_spans: int = 8192

    def __post_init__(self):
        if not (0 < self.s_min <= self.s_max):
            raise ValueError(f"require 0 < s_min <= s_max, got "
                             f"[{self.s_min}, {self.s_max}]")
        if not (0.0 <= self.retrieval_bias_p <= 1.0):
            raise ValueError("retrieval_bias_p must be in [0, 1]")
        if self.index_shards < 0:
            raise ValueError("index_shards must be >= 0 (0 = auto)")
        if self.reshard_skew_threshold < 0 \
                or self.reshard_tombstone_threshold < 0:
            raise ValueError("reshard thresholds must be >= 0 "
                             "(0 disables)")
        if self.reshard_min_rows < 0:
            raise ValueError("reshard_min_rows must be >= 0")
        if self.reshard_max_shards < 1:
            raise ValueError("reshard_max_shards must be >= 1")
        if self.reshard_growth_factor < 2:
            raise ValueError("reshard_growth_factor must be >= 2 "
                             "(a skew trigger must grow the count)")
        if self.coarse_mult < 1:
            raise ValueError("coarse_mult must be >= 1 (C = "
                             "coarse_mult * k must cover the top-k)")
        if self.scan_bits < 1:
            raise ValueError("scan_bits must be >= 1")
        if self.query_cache_size < 1:
            raise ValueError("query_cache_size must be >= 1")
        if not (0.0 < self.query_cache_threshold <= 1.0):
            raise ValueError("query_cache_threshold must be in (0, 1] "
                             "(1.0 = exact-match hits only)")
        if self.summary_cache_size < 0:
            raise ValueError("summary_cache_size must be >= 0 "
                             "(0 disables the cache)")
        if self.ingest_max_pending_docs < 1 \
                or self.ingest_docs_per_tick < 1 \
                or self.ingest_embed_batch < 1 \
                or self.ingest_max_pending_ops < 1:
            raise ValueError("ingest_* settings must be >= 1")
        if self.obs_max_spans < 1:
            raise ValueError("obs_max_spans must be >= 1")

    def scaled_bounds(self, scale: float) -> "EraRAGConfig":
        """Tab V ablation: scale tolerance delta around the mean size."""
        mid = (self.s_min + self.s_max) / 2
        delta = (self.s_max - self.s_min) / 2 * scale
        lo = max(1, int(round(mid - delta)))
        hi = max(lo, int(round(mid + delta)))
        return dataclasses.replace(self, s_min=lo, s_max=hi)


def _asdict(obj) -> Dict[str, Any]:
    d = dataclasses.asdict(obj)
    d["__class__"] = type(obj).__name__
    return d


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (arch family defines which fields matter)."""

    name: str
    kind: str  # training | inference-prefill | inference-decode |
    # long-context-decode | full-batch | sampled-training |
    # full-batch-large | batched-small-graphs | online-inference |
    # offline-scoring | retrieval-scoring
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # GNN fields
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    graph_batch: int = 0
    # RecSys fields
    batch: int = 0
    n_candidates: int = 0

    @property
    def is_decode(self) -> bool:
        return self.kind in ("inference-decode", "long-context-decode")

    @property
    def is_prefill(self) -> bool:
        return self.kind == "inference-prefill"

    @property
    def is_training(self) -> bool:
        return self.kind in ("training", "sampled-training", "full-batch",
                             "full-batch-large", "batched-small-graphs")

    def to_json(self) -> Dict[str, Any]:
        return _asdict(self)


@dataclass(frozen=True)
class ArchConfig:
    """Base class for the architecture configs."""

    name: str = ""
    family: str = ""  # lm-dense | lm-moe | gnn | recsys
    source: str = ""  # citation tag, e.g. "arXiv:2407.21783; unverified"
    shapes: Tuple[ShapeSpec, ...] = ()

    def reduced(self) -> "ArchConfig":  # pragma: no cover - overridden
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(_asdict(self), default=str, indent=2)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    n_shared: int = 0
    d_ff_expert: int = 0           # per-expert FFN width
    router_aux_coef: float = 0.01  # load-balance aux loss
    capacity_factor: float = 1.25  # dispatch capacity per expert


@dataclass(frozen=True)
class LMConfig(ArchConfig):
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0          # derived when 0: d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    rope_theta: float = 10000.0
    qkv_bias: bool = False   # qwen2 uses attention bias
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    # apply MoE every k-th layer (1 = all)
    moe_every: int = 1
    max_seq_len: int = 8192

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def param_count(self) -> int:
        """Total parameter count (embedding + per-layer + head)."""
        d, h = self.d_model, self.d_head
        emb = self.vocab_size * d
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) \
            + (self.n_heads * h) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * h
        norms = 2 * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        if self.moe is None:
            ffn = 3 * d * self.d_ff
            return emb + self.n_layers * (attn + ffn + norms) + head + d
        m = self.moe
        n_moe = self.n_layers // self.moe_every
        n_dense = self.n_layers - n_moe
        routed = m.n_experts * 3 * d * m.d_ff_expert
        shared = m.n_shared * 3 * d * m.d_ff_expert
        router = d * m.n_experts
        moe_ffn = routed + shared + router
        dense_ffn = 3 * d * self.d_ff
        total = emb + head + d
        total += n_moe * (attn + moe_ffn + norms)
        total += n_dense * (attn + dense_ffn + norms)
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        n_moe = self.n_layers // self.moe_every
        full = self.param_count()
        routed_all = n_moe * m.n_experts * 3 * d * m.d_ff_expert
        routed_act = n_moe * m.top_k * 3 * d * m.d_ff_expert
        return full - routed_all + routed_act

    def reduced(self) -> "LMConfig":
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            max_seq_len=128,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=32,
            )
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class GNNConfig(ArchConfig):
    n_layers: int = 0
    d_hidden: int = 0
    aggregator: str = "gated"
    d_edge: int = 0
    n_classes: int = 40
    residual: bool = True
    norm: str = "layer"  # batch-norm in the paper; layer-norm here

    def reduced(self) -> "GNNConfig":
        return dataclasses.replace(self, n_layers=2, d_hidden=16)

    def param_count(self) -> int:
        """The layers' A..E projections and two norms each (the
        reference's count: encoders and head left out)."""
        d = self.d_hidden
        per_layer = 5 * d * d + 5 * d
        return self.n_layers * per_layer


@dataclass(frozen=True)
class RecSysConfig(ArchConfig):
    n_dense: int = 0
    n_sparse: int = 0
    embed_dim: int = 0
    vocab_sizes: Tuple[int, ...] = ()   # per sparse field
    mlp_dims: Tuple[int, ...] = ()
    interaction: str = "fm"             # fm | cross | augru | multi-interest
    n_cross_layers: int = 0
    # DIEN
    seq_len: int = 0
    gru_dim: int = 0
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0

    def reduced(self) -> "RecSysConfig":
        return dataclasses.replace(
            self,
            embed_dim=min(self.embed_dim, 8),
            vocab_sizes=tuple(min(v, 128) for v in self.vocab_sizes),
            mlp_dims=tuple(min(m, 32) for m in self.mlp_dims),
            seq_len=min(self.seq_len, 8) if self.seq_len else 0,
            gru_dim=min(self.gru_dim, 16) if self.gru_dim else 0,
        )

    def param_count(self) -> int:
        """The embedding rows (unpadded) and a dense-input MLP (the
        reference's count, whatever the interaction)."""
        emb = sum(self.vocab_sizes) * self.embed_dim
        mlp_in = self.n_dense + self.n_sparse * self.embed_dim
        mlp = 0
        prev = mlp_in
        for m in self.mlp_dims:
            mlp += prev * m + m
            prev = m
        return emb + mlp
