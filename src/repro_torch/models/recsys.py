"""RecSys models: DeepFM, DCN-v2, DIEN, MIND over a fused embedding table.

The JAX package's models as torch ops on tensors.  Every field's rows
live in one *fused* table (the fields concatenated row-wise at per-field
``offsets``, the DLRM merged-table layout, padded to 256 rows); a lookup
is a row gather.  The weights are a ``ParamTree`` holding the
reference's parameter tree (``table``, ``mlp`` as a list of
``{"w", "b"}``, ...), so ``convert.params_from_numpy`` carries the JAX
package's draws over leaf by leaf.

DIEN's two GRUs run as a Python loop over the history's steps (the
reference's ``lax.scan``), each step masked past the row's
``hist_len``.  MIND's top-k is a stable descending sort, so exact ties
go to the lowest index, as ``lax.top_k`` gives them; for n divisible by
256 it runs in the reference's two stages (a top-k per block, then over
the blocks'), which return the same ids and values as one.

Inputs are tensors (or numpy arrays, moved to the weights' device);
index inputs may be int32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import RecSysConfig
from repro_torch.common.utils import as_tensor, ceil_to
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import ParamTree, dense_init
from repro_torch.models.sharding_ctx import shard

Batch = Dict[str, Any]
N_SHARDS = 256      # MIND's candidate blocks (the reference's two stages)


# ---------------------------------------------------------------------------
# fused embedding table
# ---------------------------------------------------------------------------
def fused_table_init(generator: torch.Generator, vocab_sizes: Tuple[int, ...],
                     dim: int, dtype=torch.float32, pad_to: int = 256
                     ) -> Tuple[torch.Tensor, np.ndarray]:
    """Returns (table (R, dim), offsets (F,)); R = the vocab rows
    rounded up to ``pad_to``, N(0, 0.01^2) on the generator's device."""
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
    rows = ceil_to(int(sum(vocab_sizes)), pad_to)
    table = torch.randn((rows, dim), generator=generator,
                        dtype=torch.float32, device=generator.device)
    return table.mul_(0.01).to(dtype), offsets.astype(np.int64)


def _ids(ids, device: torch.device) -> torch.Tensor:
    return as_tensor(ids, device, torch.int64)


def embedding_lookup(table: torch.Tensor, ids, offsets) -> torch.Tensor:
    """ids: (b, F) per-field local ids -> (b, F, dim)."""
    off = torch.as_tensor(np.asarray(offsets, np.int64), device=table.device)
    return table[_ids(ids, table.device) + off[None, :]]


def embedding_bag_mean(table: torch.Tensor, ids,
                       lengths) -> torch.Tensor:
    """Mean-pool a ragged bag: ids (b, L) padded, lengths (b,) valid;
    an empty bag pools to 0."""
    ids = _ids(ids, table.device)
    lengths = _ids(lengths, table.device)
    emb = table[ids]                                      # (b, L, d)
    mask = (torch.arange(ids.shape[1], device=table.device)[None, :] <
            lengths[:, None]).to(emb.dtype)
    s = torch.einsum("bld,bl->bd", emb, mask)
    return s / torch.clamp(lengths[:, None].to(emb.dtype), min=1.0)


def _mlp_init(generator, dims: Tuple[int, ...], dtype=torch.float32):
    return [{"w": dense_init(generator, a, b, dtype=dtype),
             "b": torch.zeros((b,), dtype=dtype, device=generator.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_axes(dims: Tuple[int, ...]):
    return [{"w": (None, "mlp"), "b": ("mlp",)} for _ in dims[1:]]


def _mlp_fwd(layers, x: torch.Tensor, final_act: bool = False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logit.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y +
                      torch.log1p(torch.exp(-torch.abs(z))))


# ---------------------------------------------------------------------------
# DeepFM  [arXiv:1703.04247]
# ---------------------------------------------------------------------------
def deepfm_init(cfg: RecSysConfig, generator, dtype=torch.float32):
    table, offsets = fused_table_init(generator, cfg.vocab_sizes,
                                      cfg.embed_dim, dtype)
    first, _ = fused_table_init(generator, cfg.vocab_sizes, 1, dtype)
    mlp_dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,)
    params = {"table": table, "first": first,
              "mlp": _mlp_init(generator, mlp_dims, dtype),
              "bias": torch.zeros((), dtype=dtype, device=generator.device)}
    axes = {"table": ("vocab_rows", "embed"),
            "first": ("vocab_rows", None),
            "mlp": _mlp_axes(mlp_dims), "bias": ()}
    return params, axes, offsets


def deepfm_fwd(p: ParamTree, batch: Batch, cfg: RecSysConfig,
               offsets) -> torch.Tensor:
    emb = shard(embedding_lookup(p["table"], batch["sparse"], offsets),
                ("batch", None, "embed"))
    first = embedding_lookup(p["first"], batch["sparse"],
                             offsets)[..., 0].sum(-1)     # (b,)
    s = emb.sum(dim=1)                                    # (b, d)
    fm2 = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(-1)  # (b,)
    deep = _mlp_fwd(p["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return first + fm2 + deep + p["bias"]


# ---------------------------------------------------------------------------
# DCN-v2  [arXiv:2008.13535]
# ---------------------------------------------------------------------------
def dcnv2_init(cfg: RecSysConfig, generator, dtype=torch.float32):
    table, offsets = fused_table_init(generator, cfg.vocab_sizes,
                                      cfg.embed_dim, dtype)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = [{"w": dense_init(generator, d0, d0, dtype=dtype),
              "b": torch.zeros((d0,), dtype=dtype, device=generator.device)}
             for _ in range(cfg.n_cross_layers)]
    mlp_dims = (d0,) + cfg.mlp_dims + (1,)
    params = {"table": table, "cross": cross,
              "mlp": _mlp_init(generator, mlp_dims, dtype)}
    axes = {"table": ("vocab_rows", "embed"),
            "cross": [{"w": (None, "mlp"), "b": ("mlp",)}
                      for _ in cross],
            "mlp": _mlp_axes(mlp_dims)}
    return params, axes, offsets


def dcnv2_fwd(p: ParamTree, batch: Batch, cfg: RecSysConfig,
              offsets) -> torch.Tensor:
    emb = embedding_lookup(p["table"], batch["sparse"], offsets)
    x0 = torch.cat([as_tensor(batch["dense"], emb.device, emb.dtype),
                    emb.reshape(emb.shape[0], -1)], dim=-1)
    x0 = shard(x0, ("batch", None))
    x = x0
    for c in p["cross"]:
        x = x0 * (x @ c["w"] + c["b"]) + x     # DCN-v2 full-rank cross
    return _mlp_fwd(p["mlp"], x)[:, 0]


# ---------------------------------------------------------------------------
# DIEN  [arXiv:1809.03672]
# ---------------------------------------------------------------------------
def _gru_init(generator, d_in: int, d_h: int, dtype=torch.float32):
    return {"wi": dense_init(generator, d_in, 3 * d_h, dtype=dtype),
            "wh": dense_init(generator, d_h, 3 * d_h, dtype=dtype),
            "b": torch.zeros((3 * d_h,), dtype=dtype,
                             device=generator.device)}


def _gru_cell(p, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """att: optional (b,) attention scalar -> AUGRU update-gate scaling."""
    d_h = h.shape[-1]
    gi = x @ p["wi"] + p["b"]
    gh = h @ p["wh"]
    r = torch.sigmoid(gi[..., :d_h] + gh[..., :d_h])
    z = torch.sigmoid(gi[..., d_h:2 * d_h] + gh[..., d_h:2 * d_h])
    n = torch.tanh(gi[..., 2 * d_h:] + r * gh[..., 2 * d_h:])
    if att is not None:
        z = z * att[:, None]                   # AUGRU (DIEN eq. 6)
    return (1.0 - z) * h + z * n


def dien_init(cfg: RecSysConfig, generator, dtype=torch.float32):
    table, offsets = fused_table_init(generator, cfg.vocab_sizes,
                                      cfg.embed_dim, dtype)
    d_h = cfg.gru_dim
    mlp_dims = (d_h + 2 * cfg.embed_dim,) + cfg.mlp_dims + (1,)
    params = {"table": table,
              "gru1": _gru_init(generator, cfg.embed_dim, d_h, dtype),
              "gru2": _gru_init(generator, cfg.embed_dim, d_h, dtype),
              "att_w": dense_init(generator, d_h, cfg.embed_dim,
                                  dtype=dtype),
              "mlp": _mlp_init(generator, mlp_dims, dtype)}
    gru_axes = {"wi": (None, "mlp"), "wh": (None, "mlp"), "b": ("mlp",)}
    axes = {"table": ("vocab_rows", "embed"),
            "gru1": dict(gru_axes), "gru2": dict(gru_axes),
            "att_w": (None, None),
            "mlp": _mlp_axes(mlp_dims)}
    return params, axes, offsets


def dien_fwd(p: ParamTree, batch: Batch, cfg: RecSysConfig,
             offsets) -> torch.Tensor:
    """batch: target (b,), hist (b, S), hist_len (b,)."""
    table = p["table"]
    hist_ids = _ids(batch["hist"], table.device)
    b, s = hist_ids.shape
    tgt = table[_ids(batch["target"], table.device)]     # (b, d)
    hist = shard(table[hist_ids], ("batch", "seq", "embed"))  # (b, S, d)
    hist_len = _ids(batch["hist_len"], table.device)
    valid = (torch.arange(s, device=table.device)[None, :] <
             hist_len[:, None])                          # (b, S)

    # interest extraction GRU
    h = torch.zeros((b, cfg.gru_dim), dtype=hist.dtype, device=hist.device)
    states = []
    for t in range(s):
        h_new = _gru_cell(p["gru1"], h, hist[:, t])
        h = torch.where(valid[:, t, None], h_new, h)
        states.append(h)
    states = torch.stack(states, dim=1)                  # (b, S, d_h)

    # target attention over interest states
    att_logits = torch.einsum("bsh,hd,bd->bs", states, p["att_w"], tgt)
    att_logits = torch.where(valid, att_logits,
                             torch.full_like(att_logits, -1e30))
    att = torch.softmax(att_logits, dim=-1)              # (b, S)

    # interest evolution AUGRU
    final = torch.zeros_like(h)
    for t in range(s):
        h_new = _gru_cell(p["gru2"], final, hist[:, t], att=att[:, t])
        final = torch.where(valid[:, t, None], h_new, final)

    hist_mean = embedding_bag_mean(table, hist_ids, hist_len)
    feat = torch.cat([final, tgt, hist_mean], dim=-1)
    return _mlp_fwd(p["mlp"], feat)[:, 0]


# ---------------------------------------------------------------------------
# MIND  [arXiv:1904.08030]
# ---------------------------------------------------------------------------
def mind_init(cfg: RecSysConfig, generator, dtype=torch.float32):
    table, offsets = fused_table_init(generator, cfg.vocab_sizes,
                                      cfg.embed_dim, dtype)
    params = {"table": table,
              "s_mat": dense_init(generator, cfg.embed_dim, cfg.embed_dim,
                                  dtype=dtype)}
    axes = {"table": ("vocab_rows", "embed"), "s_mat": (None, None)}
    return params, axes, offsets


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s dtype rule: the operands promoted to a common
    dtype (MIND's fp32 routing weights against a bf16 serving table
    give fp32), where ``torch.einsum`` would refuse mixed dtypes."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def mind_user_interests(p: ParamTree, hist, hist_len,
                        cfg: RecSysConfig) -> torch.Tensor:
    """B2I dynamic routing -> (b, K, d) interest capsules."""
    table = p["table"]
    hist = _ids(hist, table.device)
    hist_len = _ids(hist_len, table.device)
    b, s = hist.shape
    k_caps = cfg.n_interests
    low = table[hist] @ p["s_mat"]                       # (b, S, d)
    valid = (torch.arange(s, device=table.device)[None, :] <
             hist_len[:, None])
    # fixed per-position routing-logit init (the paper: random, frozen);
    # a deterministic function of the position keeps serving repeatable
    pos = torch.arange(s, dtype=torch.float32, device=table.device)
    caps = 1.0 + torch.arange(k_caps, dtype=torch.float32,
                              device=table.device)
    blog = torch.sin(pos[:, None] * caps[None])[None].expand(b, s, k_caps)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1)                  # over capsules
        w = torch.where(valid[..., None], w, torch.zeros_like(w))
        z = _einsum("bsk,bsd->bkd", w, low)
        u = _squash(z)                                   # (b, K, d)
        blog = blog + _einsum("bkd,bsd->bsk", u, low)
    return u


def mind_fwd_train(p: ParamTree, batch: Batch, cfg: RecSysConfig,
                   offsets) -> torch.Tensor:
    """Softmax over in-batch negatives; label-aware attention."""
    u = mind_user_interests(p, batch["hist"], batch["hist_len"], cfg)
    tgt = p["table"][_ids(batch["target"], u.device)]    # (b, d)
    # label-aware attention: weight interests by similarity^2 to target
    att = torch.softmax(2.0 * _einsum("bkd,bd->bk", u, tgt), dim=-1)
    user = _einsum("bk,bkd->bd", att, u)                 # (b, d)
    logits = user @ tgt.T                                # in-batch
    labels = torch.arange(user.shape[0], device=u.device)
    # mean of logsumexp(row) - row[label], the reference's loss
    return F.cross_entropy(logits, labels)


def topk_lowest_index(x: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, in
    descending order, exact ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def mind_score_candidates(p: ParamTree, batch: Batch, cfg: RecSysConfig,
                          offsets, top_k: int = 100):
    """retrieval_cand: b users x n candidates -> top-k (scores, ids).

    Batched dot over the candidate slab + max over interest capsules
    (the paper's serving rule); no per-candidate loop."""
    u = mind_user_interests(p, batch["hist"], batch["hist_len"], cfg)
    cand = shard(p["table"][_ids(batch["candidates"], u.device)],
                 ("candidates", None))                        # (n, d)
    best = _einsum("bkd,nd->bkn", u, cand).amax(dim=1)   # (b, n)
    k_eff = min(top_k, best.shape[-1])
    b, n = best.shape
    if n % N_SHARDS == 0 and n // N_SHARDS >= k_eff:
        # the reference's two stages: a top-k per block of n / 256, then
        # over the blocks' 256 k; a sharded candidate axis keeps the
        # first stage local.  Same ids and values as one stage: each
        # block keeps every candidate the whole top-k takes, ties to the
        # lowest index (block-major, then in-block order)
        blk = n // N_SHARDS
        best_r = shard(best.reshape(b, N_SHARDS, blk),
                       ("batch", "candidates", None))
        v_loc, i_loc = topk_lowest_index(best_r, k_eff)      # (b, S, k)
        base = (torch.arange(N_SHARDS, device=best.device) * blk)[None, :,
                                                                 None]
        vals, pos = topk_lowest_index(v_loc.reshape(b, -1), k_eff)
        return vals, torch.gather((i_loc + base).reshape(b, -1), 1, pos)
    return topk_lowest_index(best, k_eff)


# ---------------------------------------------------------------------------
# unified entry points
# ---------------------------------------------------------------------------
_INIT = {"fm": deepfm_init, "cross": dcnv2_init, "augru": dien_init,
         "multi-interest": mind_init}
_FWD = {"fm": deepfm_fwd, "cross": dcnv2_fwd, "augru": dien_fwd}


@torch.no_grad()
def init_params(cfg: RecSysConfig,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> Tuple[ParamTree, Dict, np.ndarray]:
    """(weights, their logical axes, field offsets), drawn on the
    generator's device (default: a new generator on ``cuda``, seed 0).
    torch's draws are not ``jax.random``'s; to hold the port against the
    JAX package, carry its weights over with
    ``convert.params_from_numpy``."""
    if generator is None:
        generator = torch.Generator(device=resolve_device()).manual_seed(0)
    params, axes, offsets = _INIT[cfg.interaction](cfg, generator, dtype)
    return ParamTree(params), axes, offsets


def loss_fn(params: ParamTree, batch: Batch, cfg: RecSysConfig,
            offsets) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if cfg.interaction == "multi-interest":
        loss = mind_fwd_train(params, batch, cfg, offsets)
        return loss, {"nll": loss}
    logit = _FWD[cfg.interaction](params, batch, cfg, offsets)
    loss = bce_loss(logit, as_tensor(batch["labels"], logit.device,
                                  torch.float32))
    return loss, {"nll": loss}


def serve_fn(params: ParamTree, batch: Batch, cfg: RecSysConfig, offsets):
    if cfg.interaction == "multi-interest":
        if "candidates" in batch:
            return mind_score_candidates(params, batch, cfg, offsets)
        u = mind_user_interests(params, batch["hist"], batch["hist_len"],
                                cfg)
        tgt = params["table"][_ids(batch["target"], u.device)]
        return _einsum("bkd,bd->bk", u, tgt).amax(dim=-1)
    return torch.sigmoid(_FWD[cfg.interaction](params, batch, cfg, offsets))
