"""LM serving parity: the port's forward passes over a KV cache and its
``Engine`` against the JAX package's, on the CPU.

Weights are drawn by the JAX package and carried over with
``params_from_numpy``.  The model functions (``prefill``,
``prefill_padded``, ``prefill_extend``, ``decode_step``) are held to
1e-5 in fp32, logits and caches, on a llama-style and a ``qkv_bias``
qwen2-style tiny config.  The engines are held on the JAX
``make_test_engine`` recipe: the same launches in the same order, each
launch's logits on its live rows within 2e-6 of the reference's (16
fp32 ulps at |logit| <= 1, the recipe's range), tokens and ``stats``
equal.  Since the two packages' CPU products differ in the last bits,
every greedy step must also beat its runner-up by more than that
tolerance, so an equal token is a real agreement and a near-tie would
show up here as a failure instead of a flaky one.  Then the port's own
invariants: batched equals sequential and a prefix hit equals the cold
path, tokenwise; a launch never writes a cache row outside its group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import LMConfig as JaxLMConfig
from repro.models import transformer as JT
from repro.obs import ManualClock as JaxClock, use_clock as jax_use_clock
from repro.obs.trace import Tracer as JaxTracer
from jax_engines import jax_engine
from repro_torch.common.config import LMConfig
from repro_torch.data.tokenizer import EOS_ID
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import ManualClock, use_clock
from repro_torch.obs.trace import Tracer
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.testing import make_test_engine
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-5          # fp32 logits and caches, port against reference
LOGIT_TOL = 2e-6    # engine logits at every launch, and greedy margins
CONFIGS = {
    "llama": dict(name="t", family="lm-dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                  max_seq_len=64),
    "qwen2": dict(name="t", family="lm-dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=1, d_ff=48, vocab_size=96,
                  max_seq_len=64, qkv_bias=True, rope_theta=1e6),
}
PROMPTS = [
    "alpha beta",
    "tell me about alpha beta",
    "gamma delta question",
    "a considerably longer question that lands in a larger padded "
    "bucket than the short prompts do",
    "epsilon zeta words",
]
CTX = "The capital of France is Paris and the river is Seine . "


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------
# the reference's model functions under ``jax.jit`` (one compile a
# shape instead of one a primitive; the same functions)
_STATIC = ("cfg", "max_len", "compute_dtype")
JT_prefill, JT_padded = (jax.jit(f, static_argnames=_STATIC)
                         for f in (JT.prefill, JT.prefill_padded))
JT_extend, JT_decode = (jax.jit(f, static_argnames=_STATIC[::2])
                        for f in (JT.prefill_extend, JT.decode_step))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model_pair(request):
    """(JAX params, the port's LM, JAX cfg, port cfg); the reference's
    ``init_params`` draw (key 1) under ``jax.jit``, and the qwen2-style
    biases drawn nonzero so they count."""
    kw = CONFIGS[request.param]
    cfg_j, cfg_t = JaxLMConfig(**kw), LMConfig(**kw)
    params = jax.jit(lambda k: JT.init_params(cfg_j, k)[0])(
        jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    if cfg_t.qkv_bias:
        rng = np.random.default_rng(2)
        attn = tree["layers"][0]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = rng.standard_normal(attn[name].shape).astype(
                np.float32) * 0.1
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg_t, device="cpu"), cfg_j, cfg_t)


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    err = float(np.max(np.abs(got - np.asarray(want))))
    assert err <= TOL, (what, err)


def _close_cache(got, want):
    for name in ("k", "v"):
        _close(got[name], want[0][name], name)


def _padded(rng, lengths, width, vocab):
    tokens = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(4, vocab, size=n)
    return tokens, np.asarray(lengths, np.int32)


def test_make_kv_cache_matches_reference_layout(model_pair):
    _, _, cfg_j, cfg_t = model_pair
    want = JT.make_kv_cache(cfg_j, 3, 16, jnp.float32)
    got = T.make_kv_cache(cfg_t, 3, 16, torch.float32, device="cpu")
    assert set(got) == {"k", "v"} and len(want) == 1
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[0][name].shape
        assert not got[name].any()


def test_prefill_matches_reference(model_pair):
    params, model, cfg_j, cfg_t = model_pair
    tokens = np.random.default_rng(0).integers(4, cfg_t.vocab_size,
                                               (2, 11)).astype(np.int32)
    want = JT_prefill(params, jnp.asarray(tokens), cfg=cfg_j, max_len=16,
                      compute_dtype=jnp.float32)
    got = T.prefill(model, tokens, cfg_t, max_len=16,
                    compute_dtype=torch.float32)
    _close(got[0], want[0], "logits")
    _close_cache(got[1], want[1])


def test_prefill_padded_matches_reference(model_pair):
    params, model, cfg_j, cfg_t = model_pair
    tokens, lengths = _padded(np.random.default_rng(0), [3, 9, 16, 11],
                              16, cfg_t.vocab_size)
    want = JT_padded(params, jnp.asarray(tokens), jnp.asarray(lengths),
                     cfg=cfg_j, max_len=32, compute_dtype=jnp.float32)
    got = T.prefill_padded(model, tokens, lengths, cfg_t, max_len=32,
                           compute_dtype=torch.float32)
    _close(got[0], want[0], "logits")
    _close_cache(got[1], want[1])
    # into a live cache: batch row j lands in slot slots[j], rows past
    # len(slots) and every other slot stay as they were
    live = T.make_kv_cache(cfg_t, 6, 32, torch.float32, device="cpu")
    live["k"].fill_(3.0)
    logits, _ = T.prefill_padded(model, tokens, lengths, cfg_t,
                                 compute_dtype=torch.float32, caches=live,
                                 slots=[4, 0])
    _close(logits, want[0], "logits into a live cache")
    for j, slot in enumerate([4, 0]):
        _close(live["k"][:, slot, :, :16], want[1][0]["k"][:, j, :, :16],
               "k")
        assert (live["k"][:, slot, :, 16:] == 3.0).all()
    for slot in (1, 2, 3, 5):
        assert (live["k"][:, slot] == 3.0).all()


def test_prefill_extend_matches_reference(model_pair):
    """Per-row offsets including 0, and a row of length 0."""
    params, model, cfg_j, cfg_t = model_pair
    rng = np.random.default_rng(1)
    base, lengths0 = _padded(rng, [16, 9, 12, 4], 16, cfg_t.vocab_size)
    _, jc = JT_padded(params, jnp.asarray(base), jnp.asarray(lengths0),
                      cfg=cfg_j, max_len=32, compute_dtype=jnp.float32)
    _, tc = T.prefill_padded(model, base, lengths0, cfg_t, max_len=32,
                             compute_dtype=torch.float32)
    suffix, lengths = _padded(rng, [8, 3, 0, 5], 8, cfg_t.vocab_size)
    offsets = np.array([16, 9, 0, 4], np.int32)
    want = JT_extend(params, jnp.asarray(suffix), jnp.asarray(lengths),
                     jnp.asarray(offsets), jc, cfg=cfg_j,
                     compute_dtype=jnp.float32)
    got = T.prefill_extend(model, suffix, lengths, offsets, tc, cfg_t,
                           compute_dtype=torch.float32)
    live = [b for b in range(4) if lengths[b]]
    _close(got[0][live], np.asarray(want[0])[live], "logits")
    _close_cache(got[1], want[1])


def test_decode_step_matches_reference(model_pair):
    params, model, cfg_j, cfg_t = model_pair
    rng = np.random.default_rng(2)
    tokens, lengths = _padded(rng, [12, 12, 12], 12, cfg_t.vocab_size)
    _, jc = JT_padded(params, jnp.asarray(tokens), jnp.asarray(lengths),
                      cfg=cfg_j, max_len=20, compute_dtype=jnp.float32)
    _, tc = T.prefill_padded(model, tokens, lengths, cfg_t, max_len=20,
                             compute_dtype=torch.float32)
    for pos in (12, 13, 14):
        step = rng.integers(4, cfg_t.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = JT_decode(params, jnp.asarray(step), jc, jnp.int32(pos),
                           cfg=cfg_j, compute_dtype=jnp.float32)
        tl, tc = T.decode_step(model, step, tc, pos, cfg_t,
                               compute_dtype=torch.float32)
        _close(tl, jl, f"logits at {pos}")
        _close_cache(tc, jc)
    assert T.greedy_sample(tl).tolist() == \
        np.asarray(JT.greedy_sample(jl)).tolist()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def recipe_tree():
    """The JAX ``make_test_engine`` recipe's weights as numpy."""
    return jax.tree.map(np.asarray, jax_engine().params)


class Launches:
    """Each launch's logits, in order, from the engine's three launch
    attributes (the reference's jitted callables, the port's methods)
    and, for the port, the rows it serves."""

    ROWS = {"_prefill_bucket": 2, "_decode_step": 2, "_prefill_extend": 3}

    def __init__(self, engine, port: bool):
        self.logits, self.rows = [], []
        for name, at in self.ROWS.items():
            setattr(engine, name, self._wrap(getattr(engine, name), name,
                                             at, port))

    def _wrap(self, fn, name, at, port):
        def run(*args):
            out = fn(*args)
            self.logits.append(out[0].to(torch.float32).numpy() if port
                               else np.array(out[0], np.float32))
            if port:
                rows = args[at]
                self.rows.append(list(range(len(rows)))
                                 if name == "_prefill_bucket" else
                                 list(rows))
            return out
        return run

    def assert_matches(self, ref: "Launches") -> None:
        """Same launches; live-row logits within LOGIT_TOL; every
        greedy step's margin above it."""
        assert len(self.logits) == len(ref.logits)
        for got, want, rows in zip(self.logits, ref.logits, self.rows):
            got, want = got[rows], want[rows]
            err = float(np.max(np.abs(got - want)))
            assert err <= LOGIT_TOL, err
            top = np.sort(got, axis=1)[:, -2:]
            margin = float(np.min(top[:, 1] - top[:, 0]))
            assert margin > LOGIT_TOL, margin


@pytest.fixture
def engines(recipe_tree):
    """``build(**kw) -> (jax engine, port engine, launch check)`` on the
    same recipe and weights."""
    def build(**kw):
        je = jax_engine(**kw)
        pe = make_test_engine(device="cpu", params=recipe_tree, **kw)
        want, got = Launches(je, port=False), Launches(pe, port=True)
        return je, pe, lambda: got.assert_matches(want)
    return build


def _same(build, run, **kw):
    """``run(engine)`` on both packages: equal outputs and stats, the
    launches' logits close.  Returns the port engine and its output."""
    je, pe, check = build(**kw)
    want, got = run(je), run(pe)
    assert got == want
    assert pe.stats == je.stats
    check()
    return pe, got


def test_generate_batch_and_generate_match_reference(engines):
    _, bat = _same(engines, lambda e: e.generate_batch(PROMPTS),
                   max_batch=len(PROMPTS))
    seq_eng, seq = _same(engines,
                         lambda e: [e.generate(p) for p in PROMPTS],
                         max_batch=1)
    assert bat == seq                     # batched equals sequential
    assert seq_eng.stats["prefill_launches"] == len(PROMPTS)


def test_prefill_launch_sharing_matches_reference(engines):
    prompts = ["one two three", "four five six",
               "a b c d e f g h i j k l m n",
               "o p q r s t u v w x y z aa bb"]
    eng, _ = _same(engines, lambda e: e.generate_batch(prompts),
                   max_batch=4)
    assert eng.stats["prefill_prompts"] == 4
    assert eng.stats["prefill_launches"] == 2
    assert eng.stats["slot_steps"] > eng.stats["decode_launches"]


def test_long_prompt_truncates_without_neighbor_corruption(engines):
    kw = dict(max_seq_len=32, max_new_tokens=8)
    long_p = "pad " * 200 + "tail words"
    short_p = "short question about alpha"
    _, solo = _same(engines, lambda e: e.generate(short_p), max_batch=1,
                    **kw)
    _, first = _same(engines, lambda e: e.generate_batch([long_p, short_p]),
                     max_batch=2, **kw)
    assert first[1] == solo
    assert 1 <= len(first[0].split()) <= kw["max_new_tokens"]


def test_absurd_budget_clamped(engines):
    eng, out = _same(engines,
                     lambda e: e.generate("some words here",
                                          max_new_tokens=10_000),
                     max_batch=1, max_seq_len=32, max_new_tokens=8)
    assert out and not any(s.active for s in eng.slots)


@pytest.mark.parametrize("toks,want", [
    ([7, 9, EOS_ID], "tok7 tok9"),           # terminal EOS stripped
    ([EOS_ID], ""),                          # an EOS-only answer
    ([7, EOS_ID, 9], "tok7 tok2 tok9"),      # budget end: untouched
])
def test_eos_handling_matches_reference(recipe_tree, toks, want):
    out = []
    for eng in (jax_engine(), make_test_engine(device="cpu",
                                               params=recipe_tree)):
        def fake(max_iters=10_000, eng=eng):
            while not eng._queue.empty():
                rid, *_ = eng._queue.get()
                eng._results[rid] = list(toks)
        eng.run_until_done = fake
        out.append(eng.generate_batch(["x"]))
    assert out == [[want], [want]]


def test_budget_validation_matches_reference(engines):
    je, pe, check = engines(max_new_tokens=3)
    for eng in (je, pe):
        for bad in (0, -3):
            with pytest.raises(ValueError):
                eng.submit("a question", max_new_tokens=bad)
        with pytest.raises(ValueError):
            eng.generate_batch(["a question"], max_new_tokens=0)
        with pytest.raises(ValueError):
            eng.submit("prompt text", prefix="not a prefix")
    outs = [e.generate("a question", max_new_tokens=None) for e in (je, pe)]
    assert outs[0] == outs[1] and 1 <= len(outs[1].split()) <= 3
    check()


def _prompts(n, ctx=CTX):
    prefix = f"Context:\n{ctx}\n\n"
    return prefix, [prefix + f"Question: q{i} capital\nAnswer:"
                    for i in range(n)]


def test_prefix_reuse_matches_reference_and_cold(engines):
    prefix, prompts = _prompts(5)
    _, cold = _same(engines, lambda e: e.generate_batch(prompts),
                    max_batch=2)
    warm, hit = _same(engines, lambda e: e.generate_batch(
        prompts, prefixes=[prefix] * len(prompts)), max_batch=2,
        prefix_cache_entries=4)
    assert hit == cold                    # hit equals cold
    assert warm.stats["prefix_hits"] == 3
    assert warm.stats["prefix_tokens_saved"] > 0


def test_prefix_cache_lru_bound_matches_reference(engines):
    pa, prompts_a = _prompts(2)
    pb, prompts_b = _prompts(2, ctx="A completely different context "
                                    "about mountains and rivers . ")
    prompts = prompts_a + prompts_b + prompts_a
    prefixes = [pa] * 2 + [pb] * 2 + [pa] * 2
    warm, got = _same(engines, lambda e: e.generate_batch(
        prompts, prefixes=prefixes), max_batch=2, prefix_cache_entries=1)
    assert len(warm._prefix_cache) <= 1
    _, cold = _same(engines, lambda e: e.generate_batch(prompts),
                    max_batch=2)
    assert got == cold


def test_prefix_declared_but_disabled_is_inert(engines):
    prefix, prompts = _prompts(3)
    eng, out = _same(engines, lambda e: e.generate_batch(
        prompts, prefixes=[prefix] * 3), max_batch=2)
    assert eng.stats["prefix_hits"] == 0 and not eng._prefix_cache
    assert out == eng.generate_batch(prompts)


def test_generate_batch_span_tree_matches_reference(recipe_tree):
    """Under a manual clock the prefill and decode spans of a mixed
    batch (two buckets, a prefix hit) match the reference's in order,
    nesting, duration and attributes."""
    prefix, prompts = _prompts(3)
    rows = []
    for eng, tracer, clock, use in (
            (jax_engine(max_batch=2, prefix_cache_entries=2), JaxTracer,
             JaxClock, jax_use_clock),
            (make_test_engine(max_batch=2, prefix_cache_entries=2,
                              device="cpu", params=recipe_tree),
             Tracer, ManualClock, use_clock)):
        with use(clock(tick=1.0)):
            eng.tracer = tracer()
            eng.generate_batch(prompts + PROMPTS[3:4],
                               prefixes=[prefix] * 3 + [None])
        rows.append([(s.name, s.depth, s.duration, sorted(s.attrs.items()))
                     for s in eng.tracer.spans])
    assert rows[0] == rows[1]
    assert ("prefix_hit", True) in [a for r in rows[1] for a in r[3]]


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------
def test_launches_write_only_their_rows(recipe_tree):
    """Every prefill, extend and decode launch leaves each cache row
    outside its group bitwise unchanged, while slots hold other live
    requests (different lengths decode in different launches)."""
    eng = make_test_engine(max_batch=4, prefix_cache_entries=2,
                           max_new_tokens=5, device="cpu",
                           params=recipe_tree)
    seen = {"prefill": 0, "extend": 0, "decode": 0}

    def guard(kind, fn, rows_of):
        def run(*args):
            before = {n: c.clone() for n, c in eng.caches.items()}
            out = fn(*args)
            rows = set(rows_of(*args))
            for n, c in eng.caches.items():
                for r in range(c.shape[1]):
                    if r not in rows:
                        assert torch.equal(c[:, r], before[n][:, r]), \
                            (kind, r)
            seen[kind] += 1
            return out
        return run

    eng._prefill_bucket = guard("prefill", eng._prefill_bucket,
                                lambda t, l, slots: slots)
    eng._prefill_extend = guard("extend", eng._prefill_extend,
                                lambda t, l, o, rows: rows)
    eng._decode_step = guard("decode", eng._decode_step,
                             lambda t, n, rows: rows)
    prefix, prompts = _prompts(6)
    eng.generate_batch(PROMPTS[:2] + prompts,
                       prefixes=[None, None] + [prefix] * 6)
    assert all(seen.values()), seen
    assert eng.stats["prefix_hits"] > 0


def test_engine_casts_once_and_keeps_the_callers_model(recipe_tree):
    """A model in another dtype is cast once at construction (its
    ``final_norm`` kept); the model passed in is left as it was."""
    cfg = LMConfig(name="t", family="lm-dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                   max_seq_len=128)
    model = params_from_numpy(recipe_tree, cfg, device="cpu")
    eng = Engine(cfg, model, EngineConfig(compute_dtype=torch.bfloat16))
    assert eng.model is not model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert eng.model.embed.dtype == torch.bfloat16
    assert eng.model.final_norm.dtype == torch.float32
    assert eng.caches["k"].dtype == torch.bfloat16
    assert eng.generate("alpha beta").startswith("tok")
    same = Engine(cfg, model, EngineConfig())
    assert same.model is model


def test_pick_sees_every_token(recipe_tree):
    """An observer that wraps ``Engine._pick`` gets each token's (request
    id, step) once, with the logits row it was chosen from."""
    eng = make_test_engine(max_batch=3, device="cpu", params=recipe_tree)
    seen = {}
    pick = eng._pick

    def observed(logits, rows, keys):
        for row, (rid, step) in zip(rows, keys):
            assert (rid, step) not in seen
            seen[rid, step] = int(torch.argmax(logits[row]))
        return pick(logits, rows, keys)

    eng._pick = observed
    outs = eng.generate_batch(PROMPTS[:3])
    for rid, out in enumerate(outs):
        toks = [int(t[3:]) for t in out.split()]
        steps = sorted(step for r, step in seen if r == rid)
        # a stripped terminal EOS was chosen too
        assert steps == list(range(len(steps)))
        assert len(steps) - len(toks) in (0, 1)
        assert [seen[rid, i] for i in range(len(toks))] == toks
