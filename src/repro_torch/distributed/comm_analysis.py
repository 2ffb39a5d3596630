"""Per-rank cost analysis of a DTensor step: collective bytes, flops,
HBM bytes, live memory, and H100 roofline terms.

The JAX package reads collective traffic from the post-GSPMD HLO text
(``distributed/hlo_analysis.py`` there).  The port has no compiled
program to read: the dry run runs the step on DTensors over fake
tensors, and ``StepCounter`` watches every op one rank runs on its local
shards.  A ``TorchDispatchMode`` sees a DTensor op first; it steps aside
(``NotImplemented``) so DTensor can pick the placements, issue the
collectives of a redistribution (``_c10d_functional`` ops) and run the
local op, and it then counts those local ops.  DTensor's own shape
propagation runs the global op on fake tensors too; those runs are not
one rank's work, and the counter is suspended over them.

Collective traffic follows the reference's convention
(``hlo_analysis.py:1-13``):

- all-reduce       : 2x payload (ring reduce-scatter + all-gather)
- all-gather       : output size
- reduce-scatter   : input size
- all-to-all       : payload
- collective-permute: payload

Flops are counted per local op: matrix products (``mm``, ``bmm``,
``addmm``, convolutions and the attention kernels that register a
formula) by ``torch.utils.flop_counter``'s formulas, under the dtype of
their operands; as XLA's cost analysis counts the rest, element-wise
arithmetic one flop an output element and reductions one an input
element, under ``elementwise``, and dtype conversions one an element,
under ``convert`` (transcendentals, copies and index ops none).  XLA on
the CPU converts every bf16 operand of a product to fp32 and counts
each conversion; ``convert`` lets the two counts be compared without
them.
HBM bytes are each non-view op's inputs read once and outputs written
once.  Live memory is the local bytes of every storage the step holds
(the arguments it is given, and each op's new outputs until their
storage is freed, as seen at the next op); its largest value is the
step's peak.

Hardware constants (NVIDIA H100 SXM5, dense, no TF32): bf16 989.4
TFLOP/s on the tensor cores, fp32 67 TFLOP/s (FMA), element-wise work
and conversions at the fp32 rate; HBM3 3.35 TB/s; NVLink 4 at 25 GB/s per link per
direction, 18 links (450 GB/s).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12,
              "elementwise": 67e12, "convert": 67e12}   # per card, dense
HBM_BW = 3.35e12                         # bytes/s per card
NVLINK_BW = 25e9                         # bytes/s per link, one way
N_LINKS = 18

# _c10d_functional op -> (kind, bytes counted: "in", "out" or "2in")
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "2in"),
    "all_reduce_coalesced": ("all-reduce", "2in"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "in"),
    "shard_dim_alltoall": ("all-to-all", "in"),
    "broadcast": ("collective-permute", "in"),
    "send": ("collective-permute", "in"),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")

# element-wise ops XLA counts as transcendentals, not flops
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "sigmoid", "tanh",
    "sqrt", "rsqrt", "sin", "cos", "pow", "erf", "silu", "gelu", "atan2"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "norm", "linalg_vector_norm", "var", "std",
               "cumsum", "argmax", "argmin", "any", "all"}
_CONVERTS = {"_to_copy", "copy_"}       # counted where the dtype changes
_NO_WORK = {"copy_", "_to_copy", "clone", "empty_like", "zeros_like",
            "ones_like", "full_like", "fill_", "zero_", "detach"}


# custom op packet -> its element-wise flops from its arguments
_ELEMENTWISE_FORMULAS: Dict[object, Callable] = {}


def register_elementwise_formula(op, formula: Callable) -> None:
    """Count ``formula(*args)`` element-wise flops a call of the custom
    op ``op`` (an ``OpOverloadPacket``): a scatter-add's adds, which XLA
    counts one a scattered element."""
    _ELEMENTWISE_FORMULAS[op] = formula


class CollectiveRecord(NamedTuple):
    kind: str               # all-reduce, all-gather, ...
    nbytes: int             # traffic under the convention above
    shape: tuple = ()       # the local shape of its (first) output


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts.  Iterative: a
    recursive closure would be a reference cycle holding the tensors
    until the garbage collector runs, and the live bytes would lag."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Counts one rank's local work under DTensor (see the module
    docstring): ``flops`` by dtype, ``hbm_bytes``, ``collectives`` (a
    list of ``CollectiveRecord``), ``live_bytes`` and ``peak_bytes``,
    ``ops`` (op name -> calls), ``op_flops`` (op name -> flops) and
    ``largest_bytes`` (the largest storage it held)."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.hbm_bytes = 0
        self.collectives: List[CollectiveRecord] = []
        self.ops: Counter = Counter()
        self.op_flops: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.largest_bytes = 0
        self._live: Dict[int, tuple] = {}    # storage -> (weak ref, bytes)
        self._suspended = 0

    # -- memory ------------------------------------------------------------
    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until the storage is freed (an
        argument of the step: a weight, a batch leaf, a moment)."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        if t.device.type == "meta":         # no memory behind it
            return
        self._sweep()
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (StorageWeakRef(st), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self.largest_bytes = max(self.largest_bytes, n)

    def _sweep(self) -> None:
        """Forget the storages freed since the last op.  A storage's
        lifetime is its own, not its Python tensor's: autograd keeps
        saved activations and gradients in C++ while their Python
        objects come and go."""
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self.live_bytes -= n

    # -- DTensor's shape propagation ---------------------------------------
    def suspend(self):
        counter = self

        class _Suspend:
            def __enter__(self):
                counter._suspended += 1

            def __exit__(self, *exc):
                counter._suspended -= 1
        return _Suspend()

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs, then its ops
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        self.ops[f"{ns}.{name}"] += 1
        ins = tensor_leaves((args, kwargs))
        outs = tensor_leaves(out)
        if ns in _COLLECTIVE_NAMESPACES:
            if name in _COLLECTIVES:
                kind, rule = _COLLECTIVES[name]
                n_in = sum(_nbytes(t) for t in ins)
                n = {"in": n_in, "2in": 2 * n_in,
                     "out": sum(_nbytes(t) for t in outs)}[rule]
                self.collectives.append(CollectiveRecord(
                    kind, n, tuple(outs[0].shape) if outs else ()))
        elif not func.is_view:
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
            before = self.total_flops
            self._count_flops(func, name, args, kwargs, out, ins, outs)
            self.op_flops[f"{ns}.{name}"] += self.total_flops - before
        if not func.is_view:
            in_keys = {_storage_key(t) for t in ins}
            for t in outs:
                if _storage_key(t) not in in_keys:
                    self.hold(t)

    def _count_flops(self, func, name, args, kwargs, out, ins, outs):
        packet = func._overloadpacket
        if packet in flop_registry:
            dt = str(ins[0].dtype).replace("torch.", "")
            self.flops[dt] += int(flop_registry[packet](
                *args, **kwargs, out_val=out))
            return
        if packet in _ELEMENTWISE_FORMULAS:
            self.flops["elementwise"] += int(
                _ELEMENTWISE_FORMULAS[packet](*args, **kwargs))
            return
        base = name.rstrip("_")
        if name in _CONVERTS and ins and outs and \
                ins[0].dtype != outs[0].dtype:
            self.flops["convert"] += outs[0].numel()
            return
        if base in _TRANSCENDENTAL or name in _NO_WORK or not outs:
            return
        if base in _REDUCTIONS and ins:
            self.flops["elementwise"] += ins[0].numel()
        elif torch.Tag.pointwise in func.tags:
            self.flops["elementwise"] += outs[0].numel()

    # -- totals --------------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def collective_breakdown(records: Union[StepCounter, List[CollectiveRecord]]
                         ) -> Dict[str, tuple]:
    """op kind -> (count, traffic bytes) using the convention above."""
    if isinstance(records, StepCounter):
        records = records.collectives
    out: Dict[str, tuple] = {}
    for r in records:
        cnt, byt = out.get(r.kind, (0, 0))
        out[r.kind] = (cnt + 1, byt + r.nbytes)
    return out


def collective_bytes(records) -> int:
    return sum(b for _, b in collective_breakdown(records).values())


def roofline_terms(flops: Union[float, Dict[str, float]], hbm_bytes: float,
                   coll_bytes: float, n_chips: int, n_links: int = N_LINKS,
                   *, peak_flops: Optional[float] = None,
                   hbm_bw: float = HBM_BW, link_bw: float = NVLINK_BW
                   ) -> Dict[str, float]:
    """Per-step seconds for each roofline term.

    ``flops`` is one rank's count: a number (at ``peak_flops``, the bf16
    peak by default) or a dict dtype -> flops, each at its own peak
    (``PEAK_FLOPS``; ``peak_flops`` for every one when given).
    ``hbm_bytes`` and ``coll_bytes`` are one rank's bytes."""
    if isinstance(flops, dict):
        t_compute = sum(f / (peak_flops or PEAK_FLOPS[dt])
                        for dt, f in flops.items())
    else:
        t_compute = flops / (peak_flops or PEAK_FLOPS["bfloat16"])
    t_memory = hbm_bytes / hbm_bw
    t_coll = coll_bytes / (link_bw * n_links)
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom[0],
        "n_chips": n_chips,
    }
