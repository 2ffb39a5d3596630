"""The weight bridge: the JAX package's LM parameter pytree, as numpy
arrays, to an ``LM`` and back.

The tree is ``transformer.init_params``'s: ``embed`` (vocab, d),
``final_norm`` (d,), ``lm_head`` (d, vocab) unless the embeddings are
tied, and ``layers``, a tuple of ``block_size`` sub-layer dicts (one for
a dense LM) whose leaves carry a leading ``n_blocks`` axis:
``{"attn": {"wq", "wk", "wv", "wo"[, "bq", "bk", "bv"]},
"ffn": {"w_gate", "w_up", "w_down"}, "ln1", "ln2"}``, where an MoE
sub-layer's ``ffn`` is ``{"router", "w_gate", "w_up", "w_down"[,
"shared": {"w_gate", "w_up", "w_down"}]}`` with the expert stacks
(e, d, f) / (e, f, d).  Sub-layer ``j`` of block ``i`` is the port's
layer ``i * block_size + j``.  torch cannot reproduce
``jax.random.PRNGKey``, so the parity tests draw the weights in JAX
and carry them over here; ``params_to_numpy(model, grads=True)`` brings
gradients back in the same tree for comparison.

The RecSys and GNN families keep the reference's tree as it is, in a
``ParamTree``: lists of MLP layers, the GNN's stacked ``layers``,
DeepFM's scalar ``bias``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common.config import ArchConfig, LMConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.layers import ParamTree
from repro_torch.models.transformer import LM, block_size, n_blocks

Leaf = Tuple[Tuple, List[torch.nn.Parameter], bool]


def param_leaves(model: LM) -> List[Leaf]:
    """Every leaf of the JAX parameter tree as (path, the port's
    parameters it holds, stacked): a ``layers`` leaf stacks one
    parameter a block on a new first axis, the others hold one."""
    cfg = model.cfg
    bs = block_size(cfg)
    out: List[Leaf] = [(("embed",), [model.embed], False),
                       (("final_norm",), [model.final_norm], False)]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), [model.lm_head], False))
    for j in range(bs):
        blocks = model.layers[j::bs]
        for name, _ in blocks[0].named_parameters():
            out.append((("layers", j) + tuple(name.split(".")),
                        [b.get_parameter(name) for b in blocks], True))
    return out


def param_tree(model: LM, leaf: Callable[[List[torch.nn.Parameter], bool],
                                         Any]) -> Dict:
    """The JAX parameter tree of ``model`` with each leaf
    ``leaf(parameters, stacked)`` (see ``param_leaves``)."""
    tree: Dict = {"layers": tuple({} for _ in range(block_size(model.cfg)))}
    for path, params, stacked in param_leaves(model):
        node = tree["layers"][path[1]] if path[0] == "layers" else tree
        keys = path[2:] if path[0] == "layers" else path
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf(params, stacked)
    return tree


def _at(tree: Dict, path: Tuple):
    node = tree
    for key in path:
        node = node[key]
    return node


def _tree_of_numpy(tree: Any, device: torch.device, dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_of_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_of_numpy(v, device, dtype) for v in tree]
    a = np.array(tree, copy=True)
    t = torch.from_numpy(a).to(device)
    return t.to(dtype) if t.is_floating_point() else t


@torch.no_grad()
def params_from_numpy(tree: Dict, cfg: ArchConfig,
                      device: Optional[torch.device] = None,
                      dtype=torch.float32) -> Union[LM, ParamTree]:
    """The port's weights holding a JAX parameter tree (numpy leaves),
    on ``device`` (default ``cuda``): an ``LM`` for an ``LMConfig``, a
    ``ParamTree`` of the same tree for the RecSys and GNN families."""
    device = resolve_device(device)
    if not isinstance(cfg, LMConfig):
        return ParamTree(_tree_of_numpy(tree, device, dtype))
    model = LM(cfg, dtype, device)
    if len(tree["layers"]) != block_size(cfg):
        raise ValueError(f"{len(tree['layers'])} sub-layers a block for "
                         f"blocks of {block_size(cfg)}")

    def put(param: torch.nn.Parameter, a) -> None:
        if tuple(np.shape(a)) != tuple(param.shape):
            raise ValueError(f"shape {np.shape(a)} for a parameter of shape "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(a, copy=True)))

    for path, params, stacked in param_leaves(model):
        a = _at(tree, path)
        if not stacked:
            put(params[0], a)
            continue
        if len(a) != n_blocks(cfg):
            raise ValueError(f"{path}: {len(a)} blocks, not "
                             f"{n_blocks(cfg)}")
        for i, p in enumerate(params):
            put(p, a[i])
    return model


def params_to_numpy(model: Union[LM, ParamTree], *,
                    grads: bool = False) -> Dict:
    """The JAX parameter tree of ``model``'s weights (or, with
    ``grads``, of their ``.grad``s) as fp32 numpy arrays."""
    def fn(p):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().to("cpu", torch.float32).numpy()

    if isinstance(model, ParamTree):
        return model.tree(fn)
    return param_tree(model, lambda ps, stacked: np.stack(
        [fn(p) for p in ps]) if stacked else fn(ps[0]))
