"""DTensor sharding rules for the port's custom ops.

DTensor picks an op's placements from a strategy registered for it.
``register_op_rule`` registers the strategies of one op written for a
single mesh dimension (a list of placements, the outputs' then the
inputs', ``None`` for a non-tensor argument), expanded over every mesh
dimension.  An expansion is kept only where every sharded dim of every
input divides evenly over its mesh axes: the ops' local shards must
line up (a rank's query heads whole groups of its key/value heads, a
rank's edges with its segment plan).  Importing this module does not
load DTensor; the dry run (``launch/dryrun.py``) registers the rules.
"""
from __future__ import annotations

from typing import Callable, List, Sequence


def _divides(specs) -> bool:
    from torch.distributed.tensor import Shard
    for spec in specs:
        if spec is None or spec.tensor_meta is None:
            continue
        for d, size in enumerate(spec.tensor_meta.shape):
            n = 1
            for mesh_dim, p in enumerate(spec.placements):
                if isinstance(p, Shard) and p.dim == d:
                    n *= spec.mesh.size(mesh_dim)
            if size % n:
                return False
    return True


def register_op_rule(op, singles: Callable[[], List[Sequence]],
                     n_out: int) -> None:
    """Register ``singles()``'s single-mesh-dim strategies for ``op``
    (an ``OpOverload`` with ``n_out`` tensor outputs)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    def strategy(op_schema):
        return expand_to_full_mesh_op_strategy(
            op_schema.get_mesh_from_args(), op_schema,
            [list(s) for s in singles()], input_index=n_out,
            is_valid_strategy_cb=lambda ins, outs: _divides(ins))

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo())
