"""Distribution helpers: per-rank collective and cost analysis of a
DTensor step (the JAX package's ``distributed/hlo_analysis.py``
counterpart is ``comm_analysis.py``)."""
from repro_torch.distributed.comm_analysis import collective_bytes, \
    collective_breakdown, roofline_terms

__all__ = ["collective_bytes", "collective_breakdown", "roofline_terms"]
