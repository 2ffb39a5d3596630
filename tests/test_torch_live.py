"""The live-serving harness (``serving/live_harness.py``) in the PyTorch
port, held against the JAX package on the CPU.

The JAX suite's small day (``tests/test_live_serving.py``: 14
documents, seed 11, batches of 3, two query batches a phase, ingest
bursts, removals, a checkpoint and restore mid-stream and one
policy-triggered migration) runs once in each package from one
module-scoped fixture, with the extractive reader and again with the
tiny ``make_test_engine`` LM whose weights are carried over from the JAX
engine.  Both runs pass their own hard gates (old-epoch availability
through the migration window, completion, bitwise parity with the
synchronous ``committed_ops`` replay), and the two packages agree: the
schedule, every answer the day served (answer, context, tokens, hits,
epoch), the graph's nodes, the final store's rows, and the reports
outside ``EXCEPTED``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.common.config import EraRAGConfig as JaxConfig
from repro.data.corpus import SyntheticCorpus as JaxCorpus
from repro.embed.hashing import HashingEmbedder as JaxEmbedder
from repro.serving import rag_pipeline as jax_pipeline
from repro.serving.live_harness import LiveHarness as JaxHarness, \
    make_schedule as jax_schedule
from repro.serving.testing import make_test_engine as jax_engine

from repro_torch.common.config import EraRAGConfig
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.embed.hashing import HashingEmbedder
from repro_torch.serving import rag_pipeline as port_pipeline
from repro_torch.serving.live_harness import LiveHarness, make_schedule
from repro_torch.serving.testing import make_test_engine

pytestmark = pytest.mark.live

# the JAX live suite's configuration
KW = dict(embed_dim=32, n_hyperplanes=8, s_min=2, s_max=4, max_layers=3,
          chunk_tokens=16, top_k=6, token_budget=512, index_shards=2,
          query_cache=True)
CFG = EraRAGConfig(**KW)

EXCEPTED = {
    # host-clock timings of each phase's query batches
    "phases.*.p50_ms",
    "phases.*.p99_ms",
    # the process-wide mips_topk counter: the port counts the card's
    # CUDA launches only, so it reads 0 on the CPU (ROADMAP.md, queue 3,
    # recorded divergence 1)
    "phases.*.obs.kernel_launches",
}


def _mk_emb():
    return HashingEmbedder(dim=32, n_features=512, seed=0)


def _mk_jax_emb():
    return JaxEmbedder(dim=32, n_features=512, seed=0)


def _flat(x, prefix=""):
    """``{dotted path: value}`` of a nested report, list items by index
    under ``*`` so the keys of every phase share one pattern."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    if isinstance(x, list) and x and isinstance(x[0], dict):
        out = {}
        for i, v in enumerate(x):
            out.update({f"{k}#{i}": val for k, val in
                        _flat(v, f"{prefix}.*").items()})
        return out
    return {prefix: x}


def _pattern(key: str) -> str:
    return key.split("#")[0]


class _Recorder:
    """Every ``RAGPipeline.answer_batch`` answer of one package, in
    order, while active."""

    def __init__(self, module):
        self.cls, self.answers = module.RAGPipeline, []

    def __enter__(self):
        orig = self.orig = self.cls.answer_batch
        rec = self.answers

        def answer_batch(pipe, questions, *a, **kw):
            out = orig(pipe, questions, *a, **kw)
            rec.extend((r.answer, r.context, r.n_context_tokens, r.hits,
                        r.epoch) for r in out)
            return out

        self.cls.answer_batch = answer_batch
        return self

    def __exit__(self, *exc):
        self.cls.answer_batch = self.orig


@pytest.fixture(scope="module", params=["extractive", "engine"])
def days(request, tmp_path_factory):
    """One live day in each package: ``{"jax": (harness, report,
    answers), "port": (...), "schedules": (jax, port)}``."""
    tree = jax.tree.map(np.asarray, jax_engine().params) \
        if request.param == "engine" else None
    jsched = jax_schedule(JaxCorpus.generate(n_docs=14, seed=11), seed=11,
                          query_batch=3, queries_per_phase=2)
    psched = make_schedule(SyntheticCorpus.generate(n_docs=14, seed=11),
                           seed=11, query_batch=3, queries_per_phase=2)
    jh = JaxHarness(JaxConfig(**KW), _mk_jax_emb, jsched,
                    tmp_path_factory.mktemp("jax"), compact_threshold=0.1,
                    engine_factory=jax_engine if tree is not None else None)
    ph = LiveHarness(CFG, _mk_emb, psched, tmp_path_factory.mktemp("port"),
                     compact_threshold=0.1, device="cpu",
                     engine_factory=(lambda: make_test_engine(
                         device="cpu", params=tree))
                     if tree is not None else None)
    out = {"schedules": (jsched, psched)}
    for name, harness, module in (("jax", jh, jax_pipeline),
                                  ("port", ph, port_pipeline)):
        with _Recorder(module) as rec:
            report = harness.run()
        out[name] = (harness, report, rec.answers)
    return out


# ---------------------------------------------------------------------------
# the schedule generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,query_batch", [(7, 4), (11, 3), (3, 64)])
def test_schedule_equals_reference(seed, query_batch):
    want = jax_schedule(JaxCorpus.generate(n_docs=20, seed=seed),
                        seed=seed, query_batch=query_batch)
    got = make_schedule(SyntheticCorpus.generate(n_docs=20, seed=seed),
                        seed=seed, query_batch=query_batch)
    assert got.base_docs == want.base_docs
    assert [(p.name, p.events) for p in got.phases] == \
        [(p.name, p.events) for p in want.phases]
    assert (got.probe_questions, got.parity_flat, got.parity_hop) == \
        (want.probe_questions, want.parity_flat, want.parity_hop)


def test_schedule_is_deterministic_and_covers_every_event_kind():
    corpus = SyntheticCorpus.generate(n_docs=12, seed=3)
    s1, s2 = make_schedule(corpus, seed=7), make_schedule(corpus, seed=7)
    assert [(p.name, p.events) for p in s1.phases] == \
        [(p.name, p.events) for p in s2.phases]
    s3 = make_schedule(corpus, seed=8)
    assert [(p.name, p.events) for p in s1.phases] != \
        [(p.name, p.events) for p in s3.phases]
    kinds = {ev[0] for ph in s1.phases for ev in ph.events}
    assert kinds == {"insert", "remove", "query", "snapshot",
                     "restore", "migrate", "idle"}
    assert {ev[2] for ph in s1.phases for ev in ph.events
            if ev[0] == "query"} == {"collapsed", "multihop"}
    assert all(d.split(":", 1)[0].startswith("ns")
               for d, _ in s1.base_docs)


def test_harness_flat_store_rejected():
    sched = make_schedule(SyntheticCorpus.generate(n_docs=8, seed=3),
                          seed=7)
    with pytest.raises(ValueError):
        LiveHarness(dataclasses.replace(CFG, index_shards=1), _mk_emb,
                    sched, "/tmp/unused", device="cpu")


# ---------------------------------------------------------------------------
# one day in each package
# ---------------------------------------------------------------------------

def test_run_gates_pass_in_both(days):
    for name in ("jax", "port"):
        _, report, _ = days[name]
        assert report["parity"]["bitwise"] is True, name
        mig = report["migration"]
        assert mig["completed"] and mig["availability"] == 1.0
        assert mig["old_shards"] == CFG.index_shards
        assert mig["new_shards"] == \
            CFG.index_shards * CFG.reshard_growth_factor
        assert mig["new_epoch"] == mig["old_epoch"] + 1
        assert mig["probe_rounds"] >= 1 and mig["post_matches_ref"]
        assert [p["name"] for p in report["phases"]] == [
            "baseline", "growth", "churn", "checkpoint", "migration",
            "steady"]
        timed = [p for p in report["phases"] if "p50_ms" in p]
        assert timed and all(p["p99_ms"] >= p["p50_ms"] for p in timed)
        ops = report["service"]
        assert ops["committed_bursts"] >= 2 and ops["removals"] >= 1
        assert ops["pending_ops"] == 0
        growth = report["phases"][1]["launches"]
        assert growth["embedder.encode_calls"] > 0
        assert growth["summarizer.summarize_launches"] > 0
        assert growth["retrieval_rounds"] > 0
        assert report["store_counters"]["refreshes"] > 0
        assert report["store_counters"]["reshard_steps"] == \
            mig["new_shards"]
        assert report["final_shards"] == mig["new_shards"]


def test_reports_equal_outside_named_keys(days):
    want, got = _flat(days["jax"][1]), _flat(days["port"][1])
    assert set(got) == set(want)
    differ = {_pattern(k) for k in got if got[k] != want[k]}
    assert differ <= EXCEPTED, sorted(differ - EXCEPTED)
    # the named divergence: no CUDA launch on the CPU
    assert {got[k] for k in got
            if _pattern(k) == "phases.*.obs.kernel_launches"} == {0}
    assert days["port"][1]["store_counters"]["compactions"] >= 1


def test_every_answer_node_and_row_equal(days):
    jh, _, janswers = days["jax"]
    ph, _, panswers = days["port"]
    # every answer of the day (the twin's parity sweep included), in
    # order, with the epoch it was served from
    assert len(panswers) == len(janswers) > 0
    assert panswers == janswers
    assert list(ph.rag.graph.nodes) == list(jh.rag.graph.nodes)
    for nid, node in ph.rag.graph.nodes.items():
        ref = jh.rag.graph.nodes[nid]
        assert node.text == ref.text and node.layer == ref.layer
        np.testing.assert_array_equal(np.asarray(node.embedding),
                                      np.asarray(ref.embedding))
    port, ref = ph.rag.store.state_dict(), jh.rag.store.state_dict()
    assert (port["n_shards"], port["version"], port["next_seq"]) == \
        (ref["n_shards"], ref["version"], ref["next_seq"])
    for ps, rs in zip(port["shards"], ref["shards"]):
        assert list(ps["row_ids"]) == list(rs["row_ids"])
        for key in ("buf", "row_layers", "row_seq", "alive"):
            np.testing.assert_array_equal(ps[key], np.asarray(rs[key]))
    assert ph.svc.committed_ops == jh.svc.committed_ops
