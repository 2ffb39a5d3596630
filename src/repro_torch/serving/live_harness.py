"""Replayable "live corpus day" harness: sustained mixed traffic.

This harness drives the full serving stack (``RAGPipeline`` +
``IngestService`` + the lifecycle manager) through a seeded, phased
arrival schedule on the
one-step-per-tick discipline (each schedule event is followed by
exactly one ``IngestService.tick()``, so ingest, compaction staging
and migration steps interleave with queries the way a real serving
loop would run them).  It records per-phase latency percentiles,
per-subsystem launch counts, cache movement, and the availability of
the OLD index epoch while a policy-triggered reshard migration runs,
and it is a correctness gate: the final live index must be **bitwise**
equal (graph nodes, retrieval hits, reader answers) to a synchronous
replay of ``IngestService.committed_ops`` onto a fresh index.  The
JAX package's harness, with the same schedule for the same corpus and
seed; the index lives on ``device`` (the card unless the caller asks
for the CPU).  ``obs.kernel_launches`` counts the card's ``mips_topk``
launches, so it reads 0 on the CPU.

Schedule format
---------------

A ``LiveSchedule`` is ``base_docs`` (inserted synchronously before the
run starts) plus an ordered list of ``Phase(name, events)``.  Each
event is a plain tuple, dispatched by its first element:

- ``("insert", [(doc_id, text), ...])``: submit a document burst to
  the ingest service (lands over later ticks, never inline);
- ``("remove", [doc_id, ...])``: queue a removal (an ordering barrier
  in the op log);
- ``("query", [question, ...], mode)``: one timed
  ``RAGPipeline.answer_batch`` call (``mode`` is ``collapsed`` /
  ``multihop`` / any retrieval mode);
- ``("snapshot",)``: drain the ingest queue, then take a blocking
  lifecycle checkpoint;
- ``("restore",)``: drain, restore the store from the latest
  checkpoint and delta-replay it back up to the live graph version;
- ``("migrate", [question, ...])``: arm a low-threshold
  ``LifecyclePolicy`` (via ``LifecyclePolicy.from_config``, so the
  config's ``reshard_growth_factor`` is honored), then drive the
  policy-triggered epoch-swapped migration to completion one
  ``refresh()`` turn at a time, probing the given question batch
  every turn: every mid-migration answer must come from the OLD
  epoch (``RAGAnswer.epoch``) and be bitwise the pre-migration
  answer;
- ``("idle",)``: no arrival; the tick still runs one store refresh,
  which is what advances staged compactions off the query path.

New scenarios (tenant isolation, graceful degradation, recovery under
load) slot in as new phases built from the same event tuples;
``make_schedule`` is just the default generator: Zipf-skewed query
ranks, Zipf-skewed per-namespace document volume (namespaces are
``ns{k}:`` doc-id prefixes), insert bursts, churn (remove + reinsert),
a mid-stream checkpoint/restore, one forced migration, then steady
traffic.  Same corpus + same seed => identical schedule, and the
harness itself adds no randomness, so a run is exactly replayable.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.config import EraRAGConfig
from repro_torch.core.erarag import EraRAG
from repro_torch.ingest import IngestService
from repro_torch.kernels.mips_topk import ops as mips_ops
from repro_torch.lifecycle import LifecycleManager, LifecyclePolicy
from repro_torch.obs import clock
from repro_torch.serving.rag_pipeline import RAGPipeline


@dataclass
class Phase:
    name: str
    events: List[tuple] = field(default_factory=list)


@dataclass
class LiveSchedule:
    seed: int
    query_batch: int
    base_docs: List[Tuple[str, str]]
    phases: List[Phase]
    probe_questions: List[str]       # fixed migration-window probe
    parity_flat: List[str]           # final bitwise-parity sweep
    parity_hop: List[str]


def _zipf_probs(n: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def _sample(rng: np.random.Generator, pool: Sequence[str], a: float,
            size: int) -> List[str]:
    p = _zipf_probs(len(pool), a)
    idx = rng.choice(len(pool), size=min(size, len(pool)), p=p)
    return [pool[int(i)] for i in idx]


def make_schedule(corpus, seed: int = 0, base_frac: float = 0.5,
                  namespaces: int = 3, zipf_q: float = 1.5,
                  zipf_ns: float = 1.2, query_batch: int = 4,
                  queries_per_phase: int = 4, bursts: int = 2,
                  remove_frac: float = 0.5, parity_flat: int = 12,
                  parity_hop: int = 6) -> LiveSchedule:
    """Default schedule generator over a ``SyntheticCorpus``.

    Documents get Zipf-skewed namespace prefixes (``ns0:`` is the hot
    namespace), queries are Zipf-rank samples over a seed-shuffled
    question pool (the hot questions are what the semantic query
    cache should absorb).  Phases: baseline -> growth (insert bursts
    while querying) -> churn (remove + reinsert, driving tombstone
    compactions) -> checkpoint (snapshot, more writes, restore
    mid-stream) -> migration (policy-triggered reshard, old-epoch
    probes) -> steady.
    """
    rng = np.random.Generator(np.random.PCG64(seed))
    ns_p = _zipf_probs(namespaces, zipf_ns)
    docs = [(f"ns{int(rng.choice(namespaces, p=ns_p))}:{d}", t)
            for d, t in corpus.docs]
    n_base = max(1, int(len(docs) * base_frac))
    base, growth = docs[:n_base], docs[n_base:]
    # hold back a late slice for the post-snapshot insert, so the
    # restore has a real delta tail to replay
    n_late = max(1, len(growth) // 5)
    growth_main, late = growth[:-n_late], growth[-n_late:]

    flat_pool = [qa.question for qa in corpus.qa
                 if qa.kind != "multihop"]
    hop_pool = [qa.question for qa in corpus.qa
                if qa.kind == "multihop"]
    perm = rng.permutation(len(flat_pool))
    flat_pool = [flat_pool[int(i)] for i in perm]

    def q_events(n: int, with_hop: bool = False) -> List[tuple]:
        evs: List[tuple] = []
        for _ in range(n):
            evs.append(("query",
                        _sample(rng, flat_pool, zipf_q, query_batch),
                        "collapsed"))
            evs.append(("idle",))
        if with_hop and hop_pool:
            evs.append(("query",
                        _sample(rng, hop_pool, zipf_q, query_batch),
                        "multihop"))
        return evs

    phases = [Phase("baseline", q_events(queries_per_phase,
                                         with_hop=True))]

    growth_events: List[tuple] = []
    per = max(1, -(-len(growth_main) // max(1, bursts)))
    for b in range(bursts):
        chunk = growth_main[b * per:(b + 1) * per]
        if chunk:
            growth_events.append(("insert", chunk))
        growth_events += q_events(max(1, queries_per_phase // 2))
    growth_events += [("idle",)] * 6
    phases.append(Phase("growth", growth_events))

    victims = [d for d, _ in
               growth_main[:max(1, int(len(growth_main)
                                       * remove_frac))]]
    reinsert = [dt for dt in growth_main
                if dt[0] in set(victims[:max(1, len(victims) // 2)])]
    churn: List[tuple] = [("remove", victims)]
    churn += q_events(2) + [("idle",)] * 4
    churn += [("insert", reinsert)]
    churn += q_events(max(1, queries_per_phase // 2), with_hop=True)
    churn += [("idle",)] * 6
    phases.append(Phase("churn", churn))

    ck: List[tuple] = [("snapshot",)] + q_events(1)
    ck += [("insert", late)] + q_events(2)
    ck += [("restore",)] + q_events(2)
    phases.append(Phase("checkpoint", ck))

    probe = _sample(rng, flat_pool, zipf_q, query_batch)
    phases.append(Phase("migration", [("migrate", probe)]))
    phases.append(Phase("steady", q_events(queries_per_phase,
                                           with_hop=True)))

    seen: Dict[str, None] = dict.fromkeys(flat_pool)
    return LiveSchedule(
        seed=seed, query_batch=query_batch, base_docs=base,
        phases=phases, probe_questions=probe,
        parity_flat=list(seen)[:parity_flat],
        parity_hop=hop_pool[:parity_hop])


class LiveHarness:
    """Runs one ``LiveSchedule`` against a fresh index and returns the
    measurement report.  Hard invariants (old-epoch serving during the
    migration window, migration completion, bitwise parity with the
    synchronous ``committed_ops`` replay) are asserted inside
    ``run()``; soft floors (latency, cache hit counts, compaction
    counts) are left to the caller, so smoke and full runs can relax
    them independently."""

    def __init__(self, cfg: EraRAGConfig,
                 make_embedder: Callable[[], object],
                 schedule: LiveSchedule, snapshot_dir,
                 engine_factory: Optional[Callable[[], object]] = None,
                 migration_turn_cap: int = 256,
                 compact_threshold: Optional[float] = None,
                 device=None):
        if cfg.index_shards < 2:
            raise ValueError("live harness needs a sharded store "
                             "(cfg.index_shards >= 2): migration and "
                             "compaction phases are shard-level")
        self.cfg = cfg
        self.make_embedder = make_embedder
        self.schedule = schedule
        self.snapshot_dir = snapshot_dir
        self.engine_factory = engine_factory
        self.migration_turn_cap = int(migration_turn_cap)
        self.compact_threshold = compact_threshold
        self.device = device

    # -- subsystem counter plumbing ------------------------------------
    _STORE_KEYS = ("refreshes", "compactions", "reshard_steps",
                   "rows_tombstoned", "kernel_launches")

    def _counters(self) -> Dict[str, float]:
        """Monotonic per-subsystem counters (these live on objects that
        survive a store restore, so per-phase diffs stay valid)."""
        rep = self.pipe.index_report()
        out: Dict[str, float] = {
            "retrieval_rounds": rep["launches"]["retrieval_rounds"]}

        def add(prefix: str, d: dict) -> None:
            for k, v in d.items():
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    out[f"{prefix}.{k}"] = v

        add("embedder", rep["launches"].get("embedder", {}))
        add("summarizer", rep["launches"].get("summarizer", {}))
        add("engine", rep["launches"].get("engine", {}))
        add("query_cache", rep.get("query_cache", {}))
        add("summary_cache",
            rep.get("ingest", {}).get("summary_cache", {}))
        return out

    def _bank_store(self) -> None:
        """Fold the store's counters into the run accumulator.  The
        store object is REPLACED by a restore (its counters restart at
        zero), so absolute reads can't be diffed across the run: we
        bank right before every swap instead."""
        st = self.rag.store.stats
        for k in self._STORE_KEYS:
            v = int(getattr(st, k))
            self._store_acc[k] += v - self._store_prev[k]
            self._store_prev[k] = v

    # -- the migration window ------------------------------------------
    def _run_migration(self, probes: List[str]) -> dict:
        rag, svc, pipe = self.rag, self.svc, self.pipe
        svc.drain()
        store = rag.store
        store.refresh()
        gf = rag.cfg.reshard_growth_factor
        old_epoch, old_shards = store.epoch, store.n_shards
        ref = [(a.answer, a.context, a.hits)
               for a in pipe.answer_batch(probes)]
        # arm a policy that MUST trigger (skew = max/mean >= 1 on any
        # populated store) and can grow exactly once: max_shards is
        # the post-growth count, so a second consult falls through the
        # skew branch by the n == max_shards gate.  Routed through
        # from_config so the config's growth factor is what migrates.
        pcfg = dataclasses.replace(
            rag.cfg, reshard_skew_threshold=1e-6, reshard_min_rows=1,
            reshard_max_shards=old_shards * gf)
        store.attach_lifecycle(LifecyclePolicy.from_config(pcfg))
        store.refresh()          # policy consult stages the plan
        assert store.migration is not None, \
            "reshard policy failed to trigger"
        turns = ok = probe_rounds = 0
        while store.migration is not None \
                and turns < self.migration_turn_cap:
            ans = pipe.answer_batch(probes)
            probe_rounds += 1
            good = all(a.epoch == old_epoch for a in ans) and \
                [(a.answer, a.context, a.hits) for a in ans] == ref
            ok += int(good)
            store.refresh()      # one migration turn
            turns += 1
        store.attach_lifecycle(None)
        assert store.migration is None, \
            f"migration still in flight after {turns} turns"
        post = [(a.answer, a.context, a.hits)
                for a in pipe.answer_batch(probes)]
        availability = ok / max(1, probe_rounds)
        out = {"old_epoch": int(old_epoch),
               "new_epoch": int(store.epoch),
               "old_shards": int(old_shards),
               "new_shards": int(store.n_shards),
               "turns": turns, "probe_rounds": probe_rounds,
               "availability": availability,
               "post_matches_ref": post == ref, "completed": True}
        assert availability == 1.0, \
            f"mid-migration serving diverged from the old epoch: {out}"
        assert store.epoch == old_epoch + 1 \
            and store.n_shards == old_shards * gf, out
        assert post == ref, \
            f"post-install answers diverged from pre-migration: {out}"
        return out

    # -- parity --------------------------------------------------------
    def _sweep(self, pipe: RAGPipeline) -> List[tuple]:
        B = max(1, self.schedule.query_batch)
        out: List[tuple] = []
        flat, hop = self.schedule.parity_flat, self.schedule.parity_hop
        for i in range(0, len(flat), B):
            out += [(a.answer, a.context, a.n_context_tokens, a.hits)
                    for a in pipe.answer_batch(flat[i:i + B])]
        for i in range(0, len(hop), B):
            out += [(a.answer, a.context, a.n_context_tokens, a.hits)
                    for a in pipe.answer_batch(hop[i:i + B],
                                               mode="multihop")]
        return out

    def _assert_parity(self) -> dict:
        """Bitwise gate: replay ``committed_ops`` synchronously onto a
        fresh index and compare graphs + answers."""
        rag = self.rag
        twin = EraRAG(self.cfg, self.make_embedder(),
                      device=self.device)
        twin.insert_docs(self.schedule.base_docs)
        for kind, payload in self.svc.committed_ops:
            if kind == "insert":
                twin.insert_docs(payload)
            else:
                twin.remove_docs(payload)
        twin.store.refresh()
        assert list(rag.graph.nodes) == list(twin.graph.nodes), \
            "live graph node order diverged from synchronous replay"
        for nid in rag.graph.nodes:
            na, nb = rag.graph.nodes[nid], twin.graph.nodes[nid]
            assert na.text == nb.text \
                and np.array_equal(na.embedding, nb.embedding), nid
        twin_pipe = RAGPipeline(
            twin, engine=self.engine_factory()
            if self.engine_factory else None)
        live_ans = self._sweep(self.pipe)
        twin_ans = self._sweep(twin_pipe)
        assert live_ans == twin_ans, \
            "live answers diverged from synchronous replay"
        return {"bitwise": True,
                "flat_questions": len(self.schedule.parity_flat),
                "multihop_questions": len(self.schedule.parity_hop),
                "nodes": len(rag.graph.nodes)}

    # -- the run -------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        rag = EraRAG(cfg, self.make_embedder(), device=self.device)
        self.rag = rag
        if self.compact_threshold is not None:
            rag.store._compact_threshold = float(
                self.compact_threshold)
        rag.insert_docs(self.schedule.base_docs)
        rag.store.refresh()
        self.svc = svc = IngestService(rag)
        engine = self.engine_factory() if self.engine_factory else None
        self.pipe = pipe = RAGPipeline(rag, engine=engine, ingest=svc)
        self.mgr = mgr = LifecycleManager(rag.store, self.snapshot_dir)
        self._store_acc = {k: 0 for k in self._STORE_KEYS}
        self._store_prev = {k: 0 for k in self._STORE_KEYS}

        # warm up outside the timed phases
        pipe.answer_batch(self.schedule.probe_questions)
        if self.schedule.parity_hop:
            pipe.answer_batch(self.schedule.parity_hop[:2],
                              mode="multihop")

        report: dict = {"seed": self.schedule.seed, "phases": [],
                        "migration": None}
        prev = self._counters()
        reg, tr = rag.obs.registry, rag.obs.tracer
        prev_spans = tr.total_spans
        prev_kernel = mips_ops.launch_count()
        for pi, phase in enumerate(self.schedule.phases):
            # phase-INDEXED histogram names: a schedule may repeat a
            # phase name, and percentiles must stay per-phase, not
            # accumulate across same-named phases
            hist = reg.histogram(
                f"serving.latency.{pi:02d}_{phase.name}")
            n_answers = 0
            for ev in phase.events:
                kind = ev[0]
                if kind == "insert":
                    svc.submit_many(ev[1])
                elif kind == "remove":
                    svc.remove(ev[1])
                elif kind == "query":
                    t0 = clock.now()
                    ans = pipe.answer_batch(ev[1], mode=ev[2])
                    hist.observe(clock.now() - t0)
                    n_answers += len(ans)
                elif kind == "snapshot":
                    svc.drain()
                    mgr.snapshot(block=True)
                elif kind == "restore":
                    svc.drain()
                    self._bank_store()
                    rag.store = mgr.restore(rag.graph)
                    # restore swaps in a NEW store object: re-attach
                    # the run's tracer or its spans go to NULL_TRACER
                    rag.store.tracer = rag.obs.tracer
                    self._store_prev = {k: int(getattr(
                        rag.store.stats, k))
                        for k in self._STORE_KEYS}
                    if self.compact_threshold is not None:
                        rag.store._compact_threshold = float(
                            self.compact_threshold)
                    rag.store.refresh()   # delta-replay to live head
                elif kind == "migrate":
                    report["migration"] = self._run_migration(ev[1])
                elif kind == "idle":
                    pass
                else:
                    raise ValueError(f"unknown event kind {kind!r}")
                svc.tick()
            self._bank_store()
            cur = self._counters()
            entry = {
                "name": phase.name, "events": len(phase.events),
                "query_batches": hist.count, "answers": n_answers,
                "launches": {k: cur.get(k, 0) - prev.get(k, 0)
                             for k in cur},
                # per-phase obs movement: spans recorded (0 unless
                # cfg.obs_trace) and process-global kernel dispatches
                "obs": {
                    "spans": tr.total_spans - prev_spans,
                    "kernel_launches":
                        mips_ops.launch_count() - prev_kernel}}
            prev_spans = tr.total_spans
            prev_kernel = mips_ops.launch_count()
            if hist.count:
                # exact np.percentile over the phase's raw samples,
                # now read back from the shared registry histogram
                entry["p50_ms"] = hist.percentile(50) * 1e3
                entry["p99_ms"] = hist.percentile(99) * 1e3
            report["phases"].append(entry)
            prev = cur
        svc.drain()
        rag.store.refresh()
        self._bank_store()

        report["parity"] = self._assert_parity()
        report["service"] = svc.report()
        report["store_counters"] = dict(self._store_acc)
        report["launch_totals"] = self._counters()
        report["final_epoch"] = int(rag.store.epoch)
        report["final_shards"] = int(rag.store.n_shards)
        report["index_size"] = int(rag.store.size)
        return report
