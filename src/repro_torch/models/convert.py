"""The weight bridge: the JAX package's LM parameter pytree, as numpy
arrays, to an ``LM`` and back.

The tree is ``transformer.init_params``'s: ``embed`` (vocab, d),
``final_norm`` (d,), ``lm_head`` (d, vocab) unless the embeddings are
tied, and ``layers``, a tuple of ``block_size`` dicts (one for a dense
LM) whose leaves carry a leading ``n_blocks`` axis:
``{"attn": {"wq", "wk", "wv", "wo"[, "bq", "bk", "bv"]},
"ffn": {"w_gate", "w_up", "w_down"}, "ln1", "ln2"}``.  torch cannot
reproduce ``jax.random.PRNGKey``, so the parity tests draw the weights
in JAX and carry them over here; ``params_to_numpy(model, grads=True)``
brings gradients back in the same tree for comparison.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.common.config import LMConfig, not_ported
from repro_torch.kernels.common import resolve_device
from repro_torch.models.transformer import LM


@torch.no_grad()
def params_from_numpy(tree: Dict, cfg: LMConfig,
                      device: Optional[torch.device] = None,
                      dtype=torch.float32) -> LM:
    """An ``LM`` holding the weights of a JAX parameter tree (numpy
    leaves), on ``device`` (default ``cuda``)."""
    if cfg.is_moe:
        raise not_ported("MoE layers (moe_fwd)", "11. MoE")
    device = resolve_device(device)
    model = LM(cfg, dtype, device)

    def put(param: torch.nn.Parameter, a) -> None:
        if tuple(np.shape(a)) != tuple(param.shape):
            raise ValueError(f"shape {np.shape(a)} for a parameter of shape "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(a, copy=True)))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    (blk,) = tree["layers"]          # block_size is 1 for a dense LM
    for i, layer in enumerate(model.layers):
        for attr in ("attn", "ffn"):
            mod = getattr(layer, attr)
            for name, p in mod.named_parameters():
                put(p, blk[attr][name][i])
        put(layer.ln1, blk["ln1"][i])
        put(layer.ln2, blk["ln2"][i])
    return model


def params_to_numpy(model: LM, *, grads: bool = False) -> Dict:
    """The JAX parameter tree of ``model``'s weights (or, with
    ``grads``, of their ``.grad``s) as fp32 numpy arrays."""
    def fn(p):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().to("cpu", torch.float32).numpy()

    def stack(get):
        return np.stack([fn(get(layer)) for layer in model.layers])

    def sub_tree(sub):
        names = [n for n, _ in getattr(model.layers[0], sub)
                 .named_parameters()]
        return {n: stack(lambda L, n=n: getattr(getattr(L, sub), n))
                for n in names}

    block = {"attn": sub_tree("attn"), "ffn": sub_tree("ffn")}
    block.update(ln1=stack(lambda L: L.ln1), ln2=stack(lambda L: L.ln2))
    tree = {"embed": fn(model.embed), "layers": (block,),
            "final_norm": fn(model.final_norm)}
    if not model.cfg.tie_embeddings:
        tree["lm_head"] = fn(model.lm_head)
    return tree
