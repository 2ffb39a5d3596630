"""Assigned input-shape sets, one tuple per architecture family."""
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

GNN_SHAPES = (
    ShapeSpec(name="full_graph_sm", kind="full-batch",
              n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeSpec(name="minibatch_lg", kind="sampled-training",
              n_nodes=232965, n_edges=114615892, batch_nodes=1024,
              fanout=(15, 10), d_feat=602),
    ShapeSpec(name="ogb_products", kind="full-batch-large",
              n_nodes=2449029, n_edges=61859140, d_feat=100),
    ShapeSpec(name="molecule", kind="batched-small-graphs",
              n_nodes=30, n_edges=64, graph_batch=128, d_feat=16),
)

RECSYS_SHAPES = (
    ShapeSpec(name="train_batch", kind="training", batch=65536),
    ShapeSpec(name="serve_p99", kind="online-inference", batch=512),
    ShapeSpec(name="serve_bulk", kind="offline-scoring", batch=262144),
    ShapeSpec(name="retrieval_cand", kind="retrieval-scoring",
              batch=1, n_candidates=1_000_000),
)
