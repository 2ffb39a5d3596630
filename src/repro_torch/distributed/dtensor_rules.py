"""DTensor sharding rules for the port's custom ops.

DTensor picks an op's placements from a strategy registered for it.
``register_op_rule`` registers the strategies of one op written for a
single mesh dimension (a list of placements, the outputs' then the
inputs', ``None`` for a non-tensor argument), expanded over every mesh
dimension.  An expansion is kept only where the inputs' local shards
line up (a rank's query heads whole groups of its key/value heads, a
rank's edges with its segment plan): every sharded dim of every input
divides evenly over its mesh axes, or, for an op registered with
``uneven``, splits unevenly as every other input split over those
axes does (attention over 40 query heads and their 40 repeated
key/value heads on a 16-wide axis).  Importing this module does not
load DTensor; the dry run (``launch/dryrun.py``) registers the rules.
"""
from __future__ import annotations

from typing import Callable, List, Sequence


def _splits(specs):
    """(input, dim, its size, the mesh dims splitting it, their ranks)
    for every sharded dim of every input."""
    from torch.distributed.tensor import Shard
    out = []
    for i, spec in enumerate(specs):
        if spec is None or spec.tensor_meta is None:
            continue
        for d, size in enumerate(spec.tensor_meta.shape):
            dims = tuple(m for m, p in enumerate(spec.placements)
                         if isinstance(p, Shard) and p.dim == d)
            if dims:
                n = 1
                for m in dims:
                    n *= spec.mesh.size(m)
                out.append((i, d, size, dims, n))
    return out


def _lines_up(specs, uneven: bool) -> bool:
    """Whether the inputs' local shards line up: every sharded dim
    divides over its mesh dims; or, with ``uneven``, a dim that does not
    has the size, and the mesh dims, of every other input's dim split
    over any of those mesh dims, so each rank holds the same rows of
    each (torch.chunk's uneven split, as GSPMD pads one)."""
    splits = _splits(specs)
    for i, d, size, dims, n in splits:
        if size % n == 0:
            continue
        if not uneven:
            return False
        if any(set(dims) & set(o_dims) and (o_size, o_dims) != (size, dims)
               for _, _, o_size, o_dims, _ in splits):
            return False
    return True


def register_op_rule(op, singles: Callable[[], List[Sequence]],
                     n_out: int, *, uneven: bool = False) -> None:
    """Register ``singles()``'s single-mesh-dim strategies for ``op``
    (an ``OpOverload`` with ``n_out`` tensor outputs); ``uneven`` keeps
    the expansions whose uneven splits line up (``_lines_up``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import \
        expand_to_full_mesh_op_strategy

    def strategy(op_schema):
        return expand_to_full_mesh_op_strategy(
            op_schema.get_mesh_from_args(), op_schema,
            [list(s) for s in singles()], input_index=n_out,
            is_valid_strategy_cb=lambda ins, outs: _lines_up(ins, uneven))

    DTensor._op_dispatcher.sharding_propagator.register_op_strategy(
        op, strategy, RuntimeSchemaInfo())
