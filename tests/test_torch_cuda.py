"""The port's CUDA kernels on the card, against their plain PyTorch
versions (which ``test_torch_lsh_hash.py`` / ``test_torch_mips_topk.py``
hold against the JAX package on the CPU).

Every test here carries the ``cuda`` marker and skips without a card:
the kernels have no CPU interpret mode.  This file imports no JAX (the
card's machine has none), so on the card it runs without the suite's
conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.kernels.lsh_hash import ops as lsh_ops
from repro_torch.kernels.mips_topk import ops as mips_ops

pytestmark = pytest.mark.cuda

FLIP_BAND = 1e-5    # |fp64 projection| within which a sign may flip
SCORE_TOL = 1e-5    # fp32 sums in two orders, unit-norm rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k", [(1, 256, 12), (300, 256, 12),
                                   (77, 259, 33), (64, 128, 64),
                                   (20000, 256, 12)])
def test_lsh_kernel_matches_plain(cuda, n, d, k):
    rng = np.random.default_rng(n + d + k)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[0] = 0.0
    h = rng.standard_normal((d, k)).astype(np.float32)
    before = lsh_ops.launch_count()
    got = lsh_ops.lsh_hash(torch.from_numpy(v).to(cuda),
                           torch.from_numpy(h).to(cuda))
    assert lsh_ops.launch_count() == before + 1
    want = lsh_ops.lsh_hash(torch.from_numpy(v), torch.from_numpy(h))
    diff = lsh_ops.unpack_bits(got.cpu(), k) != lsh_ops.unpack_bits(want, k)
    if diff.any():   # only bits within rounding of a zero projection
        proj = v.astype(np.float64) @ h.astype(np.float64)
        assert np.abs(proj[diff.numpy()]).max() <= FLIP_BAND
    assert lsh_ops.codes_to_int(got[:1].cpu().numpy(), k)[0] == \
        (1 << k) - 1


def _flagged_data(b, n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[[5, 9, n - 1]] = emb[2]            # exact ties
    u = rng.random(n)
    dead = (u < 0.15).astype(np.float32)
    dead[[2, 5, 9, n - 1]] = 0.0
    summary = (u > 0.7).astype(np.float32)
    db = np.concatenate([emb, dead[:, None], summary[:, None],
                         1.0 - summary[:, None]], axis=1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = emb[2]
    return q, np.ascontiguousarray(db)


@pytest.mark.parametrize("b,n,d,k", [(4, 300, 64, 8), (9, 700, 256, 8),
                                     (64, 50000, 256, 8), (5, 300, 64, 64),
                                     (3, 130, 32, 130 - 70)])
@pytest.mark.parametrize("bias", [(mips_ops.MASK_BIAS, 0.0, 0.0),
                                  (mips_ops.MASK_BIAS, mips_ops.MASK_BIAS,
                                   0.0)])
def test_mips_kernel_matches_plain(cuda, b, n, d, k, bias):
    q, db = _flagged_data(b, n, d, seed=b + n)
    qt, dbt = torch.from_numpy(q).to(cuda), torch.from_numpy(db).to(cuda)
    before = mips_ops.launch_count()
    vals, idx = mips_ops.flagged_mips_topk(qt, dbt, k, bias)
    assert mips_ops.launch_count() == before + 1
    want_v, want_i = mips_ops.flagged_mips_topk(
        torch.from_numpy(q), torch.from_numpy(db), k, bias)
    np.testing.assert_allclose(vals.cpu().numpy(), want_v.numpy(),
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(idx.cpu().numpy(), want_i.numpy())
    if bias[1] == 0.0:   # rows 2, 5, 9, n-1 tie exactly, all alive
        assert idx[0, :4].tolist() == [2, 5, 9, n - 1][:min(4, k)]
    for j in range(b):   # batch invariance, bitwise
        v1, i1 = mips_ops.flagged_mips_topk(qt[j:j + 1].contiguous(), dbt,
                                            k, bias)
        assert torch.equal(v1, vals[j:j + 1])
        assert torch.equal(i1, idx[j:j + 1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    v = torch.zeros((8, 16), device=cuda)
    with pytest.raises(TypeError):
        lsh_ops.lsh_hash(v.double(), torch.zeros((16, 4), device=cuda,
                                                 dtype=torch.float64))
    with pytest.raises(ValueError):
        lsh_ops.lsh_hash(v.T, torch.zeros((8, 4), device=cuda))
    with pytest.raises(ValueError):
        mips_ops.mips_topk(v, torch.zeros((100, 16), device=cuda), 65)
    with pytest.raises(ValueError):
        mips_ops.mips_topk(v, torch.zeros((16, 100), device=cuda).T, 4)


def test_quickstart_on_card_matches_cpu(cuda):
    cfg = EraRAGConfig(embed_dim=128, n_hyperplanes=10, s_min=4, s_max=12,
                       max_layers=3, chunk_tokens=32, top_k=8,
                       token_budget=1024)
    corpus = SyntheticCorpus.generate(n_docs=60, n_topics=6, seed=0)
    init, rounds = corpus.growth_rounds(0.5, 5)
    gpu = EraRAG(cfg, HashingEmbedder(dim=128), device=cuda)
    cpu = EraRAG(cfg, HashingEmbedder(dim=128), device="cpu")
    for docs in [init] + rounds:
        assert gpu.insert_docs(docs).tokens_total == \
            cpu.insert_docs(docs).tokens_total
    assert list(gpu.graph.nodes) == list(cpu.graph.nodes)
    questions = [qa.question for qa in corpus.qa[:30]]
    for mode in ("collapsed", "detailed", "summarized", "multihop"):
        for a, b in zip(gpu.query_batch(questions, mode=mode),
                        cpu.query_batch(questions, mode=mode)):
            assert [(h.node_id, h.seq) for h in a.hits] == \
                [(h.node_id, h.seq) for h in b.hits]
            assert a.context == b.context
            np.testing.assert_allclose([h.score for h in a.hits],
                                       [h.score for h in b.hits],
                                       rtol=0, atol=SCORE_TOL)
