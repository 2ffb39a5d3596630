"""Assigned input-shape set of the LM family."""
from repro_torch.common.config import ShapeSpec

LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="training",
              seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="inference-prefill",
              seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="inference-decode",
              seq_len=32768, global_batch=128),
    ShapeSpec(name="long_500k", kind="long-context-decode",
              seq_len=524288, global_batch=1),
)
