"""Unified model API: (arch config, shape) -> init / step fns / inputs.

The single dispatch point of the three families (LM, GNN, RecSys), as
in the JAX package.  ``step_fn`` returns the callable ``(model, batch)
-> ...`` for a shape cell; ``input_specs`` returns stand-ins on the
``meta`` device (shapes and dtypes, no allocation) and ``input_axes``
their logical axes, the reference's names as plain data; ``demo_batch``
makes the reference's small numpy draws, bitwise, as tensors on the
requested device.

``init(generator=None, dtype)`` returns (weights, logical axes): an
``LM`` or a ``ParamTree``, on the generator's device (default a new
generator on ``cuda``, seed 0).  The LM decode caches are the port's
``make_kv_cache`` layout (one K and one V over every layer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ArchConfig, GNNConfig, LMConfig, \
    RecSysConfig, ShapeSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.models import gnn, recsys, transformer

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _on(a: np.ndarray, device: Optional[torch.device]) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        resolve_device(device))


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Tuple[Any, Any]]        # generator, dtype -> (w, axes)
    step_fn: Callable[[ShapeSpec], Callable]    # shape -> (model, batch) -> ...
    input_specs: Callable[[ShapeSpec], Dict[str, Any]]
    input_axes: Callable[[ShapeSpec], Dict[str, Any]]
    demo_batch: Callable[..., Dict[str, Any]]   # shape, seed, device
    aux: Any = None                             # recsys: field offsets


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
def _lm_api(cfg: LMConfig) -> ModelAPI:
    def init(generator: Optional[torch.Generator] = None,
             dtype=torch.float32):
        return transformer.init_params(cfg, generator, dtype), \
            transformer.param_axes(cfg)

    def step_fn(shape: ShapeSpec):
        if shape.kind == "training":
            def train_step(model, batch):
                return transformer.loss_fn(model, batch, cfg)
            return train_step
        if shape.is_prefill:
            def prefill_step(model, batch):
                return transformer.prefill(model, batch["tokens"], cfg,
                                           max_len=shape.seq_len)
            return prefill_step

        def serve_step(model, batch):
            return transformer.decode_step(
                model, batch["tokens"], batch["caches"],
                batch["cache_len"], cfg)
        return serve_step

    def input_specs(shape: ShapeSpec):
        b = shape.global_batch
        if shape.kind == "training":
            return {"tokens": _meta((b, shape.seq_len), torch.int32),
                    "labels": _meta((b, shape.seq_len), torch.int32)}
        if shape.is_prefill:
            return {"tokens": _meta((b, shape.seq_len), torch.int32)}
        return {"tokens": _meta((b, 1), torch.int32),
                "caches": transformer.make_kv_cache(cfg, b, shape.seq_len,
                                                    device=META),
                "cache_len": _meta((), torch.int32)}

    def input_axes(shape: ShapeSpec):
        if shape.kind == "training" or shape.is_prefill:
            ax = {"tokens": ("batch", "seq")}
            if shape.kind == "training":
                ax["labels"] = ("batch", "seq")
            return ax
        return {"tokens": ("batch", None),
                "caches": transformer.kv_cache_axes(cfg),
                "cache_len": ()}

    def demo_batch(shape: ShapeSpec, seed: int = 0, device=None):
        rng = np.random.Generator(np.random.PCG64(seed))
        b = min(shape.global_batch, 2) or 1
        l = min(shape.seq_len, 32)
        toks = rng.integers(0, cfg.vocab_size, size=(b, l + 1),
                            dtype=np.int32)
        if shape.kind == "training":
            return {"tokens": _on(toks[:, :-1], device),
                    "labels": _on(toks[:, 1:], device)}
        if shape.is_prefill:
            return {"tokens": _on(toks[:, :-1], device)}
        caches = transformer.make_kv_cache(cfg, b, l, torch.bfloat16,
                                           resolve_device(device))
        return {"tokens": _on(toks[:, :1], device), "caches": caches,
                "cache_len": 0}

    return ModelAPI(cfg, init, step_fn, input_specs, input_axes,
                    demo_batch)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------
def _gnn_api(cfg: GNNConfig) -> ModelAPI:
    def init(generator: Optional[torch.Generator] = None,
             dtype=torch.float32, d_feat: int = 128):
        return gnn.init_params(cfg, generator, d_feat, dtype=dtype)

    def step_fn(shape: ShapeSpec):
        def train_step(model, batch):
            return gnn.loss_fn(model, batch, cfg)
        return train_step

    def _dims(shape: ShapeSpec) -> Tuple[int, int, int]:
        def pad256(x: int) -> int:
            return ((x + 255) // 256) * 256

        if shape.name == "minibatch_lg":
            # sampled subgraph: seeds * prod(fanout) upper bound
            n = shape.batch_nodes * (1 + shape.fanout[0] *
                                     (1 + shape.fanout[1]))
            e = shape.batch_nodes * shape.fanout[0] * \
                (1 + shape.fanout[1])
            return pad256(n), pad256(e), shape.d_feat
        if shape.name == "molecule":
            return (pad256(shape.n_nodes * shape.graph_batch),
                    pad256(shape.n_edges * shape.graph_batch),
                    shape.d_feat)
        return pad256(shape.n_nodes), pad256(shape.n_edges), \
            shape.d_feat

    def input_specs(shape: ShapeSpec):
        n, e, df = _dims(shape)
        return {"node_feat": _meta((n, df), torch.float32),
                "edge_index": _meta((2, e), torch.int32),
                "labels": _meta((n,), torch.int32),
                "label_mask": _meta((n,), torch.bool)}

    def input_axes(shape: ShapeSpec):
        return {"node_feat": ("nodes", None),
                "edge_index": (None, "edges"),
                "labels": ("nodes",),
                "label_mask": ("nodes",)}

    def demo_batch(shape: ShapeSpec, seed: int = 0, device=None):
        rng = np.random.Generator(np.random.PCG64(seed))
        n, e, df = 40, 120, 128  # df matches init()'s default d_feat
        ei = rng.integers(0, n, size=(2, e), dtype=np.int32)
        feat = rng.standard_normal((n, df)).astype(np.float32)
        labels = rng.integers(0, cfg.n_classes, size=(n,), dtype=np.int32)
        return {"node_feat": _on(feat, device),
                "edge_index": _on(ei, device),
                "labels": _on(labels, device),
                "label_mask": _on(np.ones(n, dtype=bool), device)}

    return ModelAPI(cfg, init, step_fn, input_specs, input_axes,
                    demo_batch)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------
def _recsys_api(cfg: RecSysConfig) -> ModelAPI:
    offsets = np.concatenate(
        [[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(np.int64)

    def init(generator: Optional[torch.Generator] = None,
             dtype=torch.float32):
        params, axes, _ = recsys.init_params(cfg, generator, dtype)
        return params, axes

    def step_fn(shape: ShapeSpec):
        if shape.kind == "training":
            def train_step(model, batch):
                return recsys.loss_fn(model, batch, cfg, offsets)
            return train_step

        def serve_step(model, batch):
            return recsys.serve_fn(model, batch, cfg, offsets)
        return serve_step

    def _batch_specs(b: int, with_labels: bool):
        specs: Dict[str, Any] = {}
        if cfg.interaction in ("fm", "cross"):
            specs["sparse"] = _meta((b, cfg.n_sparse), torch.int32)
            if cfg.n_dense:
                specs["dense"] = _meta((b, cfg.n_dense), torch.float32)
        else:
            specs["hist"] = _meta((b, cfg.seq_len), torch.int32)
            specs["hist_len"] = _meta((b,), torch.int32)
            specs["target"] = _meta((b,), torch.int32)
        if with_labels and cfg.interaction != "multi-interest":
            specs["labels"] = _meta((b,), torch.float32)
        return specs

    def input_specs(shape: ShapeSpec):
        if shape.kind == "retrieval-scoring":
            if cfg.interaction == "multi-interest":
                specs = _batch_specs(shape.batch, with_labels=False)
                specs.pop("target", None)
                specs["candidates"] = _meta((shape.n_candidates,),
                                            torch.int32)
                return specs
            # the other archs score the candidate slab as one huge
            # serve batch (batched dot, no loop)
            return _batch_specs(shape.n_candidates, with_labels=False)
        return _batch_specs(shape.batch,
                            with_labels=shape.kind == "training")

    def input_axes(shape: ShapeSpec):
        ax: Dict[str, Any] = {}
        for k, v in input_specs(shape).items():
            if k == "candidates":
                ax[k] = ("candidates",)
            elif v.dim() == 2:
                ax[k] = ("batch", None)
            elif v.dim() == 1:
                ax[k] = ("batch",)
            else:
                ax[k] = ()
        return ax

    def demo_batch(shape: ShapeSpec, seed: int = 0, device=None):
        rng = np.random.Generator(np.random.PCG64(seed))
        b = min(shape.batch or 4, 8)
        total_vocab = int(sum(cfg.vocab_sizes))
        out: Dict[str, np.ndarray] = {}
        if cfg.interaction in ("fm", "cross"):
            out["sparse"] = np.stack(
                [rng.integers(0, v, size=b) for v in cfg.vocab_sizes],
                axis=1).astype(np.int32)
            if cfg.n_dense:
                out["dense"] = rng.standard_normal(
                    (b, cfg.n_dense)).astype(np.float32)
        else:
            s = cfg.seq_len
            out["hist"] = rng.integers(0, total_vocab, size=(b, s),
                                       dtype=np.int32)
            out["hist_len"] = rng.integers(1, s + 1, size=(b,),
                                           dtype=np.int32)
            out["target"] = rng.integers(0, total_vocab, size=(b,),
                                         dtype=np.int32)
        if shape.kind == "training" and \
                cfg.interaction != "multi-interest":
            out["labels"] = rng.integers(0, 2, size=(b,)).astype(np.float32)
        if shape.kind == "retrieval-scoring" and \
                cfg.interaction == "multi-interest":
            out.pop("target", None)
            out["candidates"] = rng.integers(0, total_vocab, size=(64,),
                                             dtype=np.int32)
        return {k: _on(v, device) for k, v in out.items()}

    return ModelAPI(cfg, init, step_fn, input_specs, input_axes,
                    demo_batch, aux=offsets)


def get_api(cfg: ArchConfig) -> ModelAPI:
    if isinstance(cfg, LMConfig):
        return _lm_api(cfg)
    if isinstance(cfg, GNNConfig):
        return _gnn_api(cfg)
    if isinstance(cfg, RecSysConfig):
        return _recsys_api(cfg)
    raise TypeError(type(cfg))
