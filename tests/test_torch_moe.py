"""The MoE LM family of the port (``moe_route``/``moe_fwd``, interleaved
blocks, the weight bridge, serving) against the JAX package's, on the
CPU.

Weights are drawn by the JAX package and carried over through numpy.
- ``moe_fwd`` at the reduced deepseek-moe-16b (4 experts, top-2, a
  shared expert) and llama4-maverick (4 experts, top-1) shapes, fp32,
  at token counts where capacity drops routed tokens: output and aux
  within 1e-5; each token's experts, each expert's capacity slots and
  their liveness equal to the reference's under the margin rule below;
  identical rows, where capacity cuts between exact ties, go to the
  lowest token index in both.
- The reduced models: ``loss_fn`` (loss, nll, aux) within 1e-5 and
  every gradient leaf within 1e-4 (relative Frobenius) of ``jax.grad``;
  ``prefill``, ``prefill_padded``, ``prefill_extend`` and
  ``decode_step`` logits and caches within 1e-5.
- The engine on a tiny MoE recipe, fp32: the reference's launches in
  its order, each launch's logits within 2e-6 with every greedy margin
  above it (``test_torch_serving.Launches``), tokens and ``stats``
  equal, including a slot reused after a longer occupant while two
  groups of different lengths decode.

The margin rule for routing: a selection may differ from the
reference's only where the reference's gap between the last value
taken and the first left out lies within the largest difference of the
two packages' router logits.  The tests count such rows and assert
that there are none at their seeds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import LMConfig as JaxLMConfig
from repro.common.config import MoEConfig as JaxMoEConfig
from repro.common.registry import get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro_torch.common.config import MoEConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serving.testing import make_test_engine
from test_torch_serving import Launches
from test_torch_train import MOE_CONFIGS, _leaves, _port_of_jax_cfg, \
    _rel_fro
from jax_engines import share_launches
from torch_threads import one_blas_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5          # fp32 outputs, logits, caches and losses
GRAD_RTOL = 1e-4    # relative Frobenius error per gradient leaf
NAMES = sorted(MOE_CONFIGS)


@functools.lru_cache(maxsize=None)
def jax_reduced(name):
    """(JAX config, port config, the JAX package's ``init_params``
    weights (key 0) as numpy) of a reduced MoE config, drawn once a
    process under ``jax.jit`` (the same draw as eager but in other
    float bits; either is the reference's)."""
    cfg_j = get_arch(name).reduced()
    params = jax.jit(lambda k: JT.init_params(cfg_j, k)[0])(
        jax.random.PRNGKey(0))
    return cfg_j, _port_of_jax_cfg(cfg_j), jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# moe_fwd
# ---------------------------------------------------------------------------
def _moe_pair(name, seed=0):
    """(JAX MoE params, the port's ``MoE`` holding them, port MoEConfig,
    JAX MoEConfig, d) at the reduced config's shapes."""
    cfg_j = get_arch(name).reduced()
    p, _ = JL.moe_init(jax.random.PRNGKey(seed), cfg_j.d_model, cfg_j.moe)
    tree = jax.tree.map(np.asarray, p)
    moe = MoEConfig(**dataclasses.asdict(cfg_j.moe))
    mod = L.MoE(cfg_j.d_model, moe, device=CPU)
    with torch.no_grad():
        for n, t in mod.named_parameters():
            a = tree
            for k in n.split("."):
                a = a[k]
            t.copy_(torch.from_numpy(np.array(a)))
    mod.requires_grad_(False)
    return p, mod, moe, cfg_j.moe, cfg_j.d_model


_jax_moe_fwd = jax.jit(JL.moe_fwd, static_argnums=2)


def _jax_routing(p, x, moe):
    return {k: np.asarray(v) for k, v in _jax_routing_jit(p, x, moe).items()}


@functools.partial(jax.jit, static_argnums=2)
def _jax_routing_jit(p, x, moe):
    """The reference's routing lines (``layers.py:274-294``)."""
    b, l, d = x.shape
    t = b * l
    e, k_top = moe.n_experts, moe.top_k
    logits = x.reshape(t, d).astype(jnp.float32) @ p["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k_top)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    choice = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    gates = jnp.einsum("tk,tke->te", gate_vals, choice)
    capacity = int(np.ceil(t * k_top / e * moe.capacity_factor))
    capacity = max(1, min(capacity, t))
    sel_val, sel_idx = jax.lax.top_k(gates.T, capacity)
    return dict(logits=logits, probs=probs, gate_idx=gate_idx, gates=gates,
                sel_idx=sel_idx, live=sel_val > 0.0)


def _parted(got_idx, want_idx, want_vals, k, band):
    """Rows where a top-k selection differs from the reference's:
    (within the margin rule, beyond it).  ``want_vals`` is the row the
    reference selected from."""
    within = beyond = 0
    for row in np.nonzero((got_idx != want_idx).any(axis=1))[0]:
        vals = np.sort(want_vals[row])[::-1]
        gap = vals[k - 1] - vals[k] if k < len(vals) else np.inf
        if gap <= band:
            within += 1
        else:
            beyond += 1
    return within, beyond


def _tokens(b, l, d, skew):
    """(b, l, d) normal rows plus ``skew`` times one fixed direction,
    each scaled to an RMS of 1 (as the layer's norm leaves them): a
    skewed launch sends most tokens to the same experts, so capacity
    drops routed tokens."""
    rng = np.random.default_rng(b * 10 + l)
    x = rng.standard_normal((b, l, d)) + skew * rng.standard_normal(d)
    return (x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))
            ).astype(np.float32)


# (b, l, skew) launches: decode-like, prefill-like; the skewed ones
# drop routed tokens at capacity
SHAPES = [(1, 1, 0), (8, 1, 0), (2, 7, 0), (4, 16, 0), (8, 32, 0),
          (8, 1, 3), (4, 16, 3)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b,l,skew", SHAPES)
def test_moe_fwd_matches_reference(name, b, l, skew):
    p, mod, moe, moe_j, d = _moe_pair(name, seed=b * 100 + l)
    x = _tokens(b, l, d, skew)
    want, want_aux = _jax_moe_fwd(p, jnp.asarray(x), moe_j)
    xt = torch.from_numpy(x)
    got, aux = L.moe_fwd(mod.params(torch.float32), xt, moe)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL

    ref = _jax_routing(p, jnp.asarray(x), moe_j)
    r = L.moe_route(mod.router, xt.reshape(b * l, d), moe)
    band = float(np.max(np.abs(
        (xt.reshape(b * l, d) @ mod.router).numpy() - ref["logits"])))
    parted = [_parted(r.gate_idx.numpy(), ref["gate_idx"], ref["probs"],
                      moe.top_k, band),
              _parted(r.sel_idx.numpy(), ref["sel_idx"], ref["gates"].T,
                      r.sel_idx.shape[1], band)]
    assert all(beyond == 0 for _, beyond in parted), parted
    assert all(within == 0 for within, _ in parted), parted
    np.testing.assert_array_equal(r.gate_idx.numpy(), ref["gate_idx"])
    np.testing.assert_array_equal(r.sel_idx.numpy(), ref["sel_idx"])
    np.testing.assert_array_equal(r.live.numpy(), ref["live"])
    assert r.sel_idx.shape[1] == L.moe_capacity(b * l, moe)
    dropped = b * l * moe.top_k - int(r.live.sum())
    assert dropped == b * l * moe.top_k - int(ref["live"].sum())
    if skew:
        assert dropped > 0


@pytest.mark.parametrize("name", NAMES)
def test_exact_ties_go_to_the_lowest_token(name):
    """Identical rows (as empty prefill rows are) have bitwise equal
    gates; capacity cuts between them, and the lowest token indices
    win, in both packages."""
    p, mod, moe, moe_j, d = _moe_pair(name, seed=5)
    rng = np.random.default_rng(5)
    row = rng.standard_normal(d).astype(np.float32)
    x = np.concatenate([rng.standard_normal((3, d)).astype(np.float32),
                        np.tile(row, (29, 1))])[None]          # (1, 32, d)
    ref = _jax_routing(p, jnp.asarray(x), moe_j)
    xt = torch.from_numpy(x)
    r = L.moe_route(mod.router, xt[0], moe)
    np.testing.assert_array_equal(r.sel_idx.numpy(), ref["sel_idx"])
    np.testing.assert_array_equal(r.live.numpy(), ref["live"])
    cap = r.sel_idx.shape[1]
    ties = 0
    for ex in r.gate_idx[3].tolist():          # the repeated row's experts
        tied = [i for i in r.sel_idx[ex].tolist() if i >= 3]
        ties += len(tied)
        assert tied == sorted(tied) and tied == list(
            range(3, 3 + len(tied))), tied
    assert 0 < ties < 29 * moe.top_k and cap < 32
    want, _ = _jax_moe_fwd(p, jnp.asarray(x), moe_j)
    got, _ = L.moe_fwd(mod.params(torch.float32), xt, moe)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL


def test_moe_fwd_repeats_bitwise_in_bf16():
    _, mod, moe, _, d = _moe_pair("deepseek-moe-16b")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 16, d)).astype(np.float32)).to(torch.bfloat16)
    p = mod.params(torch.bfloat16)
    a, aux_a = L.moe_fwd(p, x, moe)
    b, aux_b = L.moe_fwd(p, x, moe)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=NAMES)
def model_pair(request):
    cfg_j, cfg, tree = jax_reduced(request.param)
    return jax.tree.map(jnp.asarray, tree), tree, cfg_j, cfg


def test_weight_bridge_round_trips(model_pair):
    _, tree, _, cfg = model_pair
    model = params_from_numpy(tree, cfg, device=CPU)
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for (pa, a), (pb, b_) in zip(_leaves(back).items(),
                                 _leaves(tree).items()):
        assert pa == pb
        np.testing.assert_array_equal(a, b_)


def test_loss_and_gradients_match_reference(model_pair):
    params, tree, cfg_j, cfg = model_pair
    from repro_torch.data.pipeline import synthetic_lm_batches
    batch = synthetic_lm_batches(cfg.vocab_size, 2, 24, seed=1)(0)
    (want, wm), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, cfg_j, compute_dtype=jnp.float32),
        has_aux=True))(params, {k: jnp.asarray(v) for k, v in
                                batch.items()})
    model = params_from_numpy(tree, cfg, device=CPU)
    loss, metrics = T.loss_fn(model, batch, cfg, compute_dtype=torch.float32)
    loss.backward()
    assert abs(loss.item() - float(want)) <= TOL
    assert abs(metrics["nll"].item() - float(wm["nll"])) <= TOL
    assert abs(metrics["aux"].item() - float(wm["aux"])) <= TOL
    assert metrics["aux"].item() > 0
    got = _leaves(params_to_numpy(model, grads=True))
    want_g = _leaves(jax.tree.map(np.asarray, grads))
    assert got.keys() == want_g.keys()
    assert any("router" in k for k in got)
    for path in want_g:
        assert _rel_fro(got[path], want_g[path]) <= GRAD_RTOL, path


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    err = float(np.max(np.abs(got - np.asarray(want))))
    assert err <= TOL, (what, err)


def _close_cache(got, want, cfg):
    """The port's (L, ...) cache against the reference's tuple of
    ``block_size`` caches, each (n_blocks, ...): layer i * bs + j is
    block i of cache j."""
    bs = T.block_size(cfg)
    assert len(want) == bs
    for name in ("k", "v"):
        for j in range(bs):
            _close(got[name][j::bs], want[j][name], f"{name}[{j}]")


def _padded(rng, lengths, width, vocab):
    tokens = np.zeros((len(lengths), width), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(4, vocab, size=n)
    return tokens, np.asarray(lengths, np.int32)


def _port_cache(jc, cfg):
    """The reference's cache tuple in the port's (L, ...) layout."""
    bs = T.block_size(cfg)
    out = {}
    for name in ("k", "v"):
        stack = torch.empty((cfg.n_layers,) + jc[0][name].shape[1:])
        for j in range(bs):
            stack[j::bs] = torch.from_numpy(np.array(jc[j][name]))
        out[name] = stack
    return out


def _close_rows(got, want, cfg, spans):
    """The cache positions each row's real tokens wrote: row b at
    ``spans[b]`` (what a row holds of padding is garbage in both)."""
    tc = _port_cache(want, cfg)
    for name in ("k", "v"):
        for b, span in enumerate(spans):
            if span.stop == span.start:
                continue
            _close(got[name][:, b, :, span],
                   tc[name][:, b, :, span].numpy(), f"{name} row {b}")


def test_serving_functions_match_reference(model_pair):
    """prefill, prefill_padded, prefill_extend, decode_step, each from
    the reference's own cache: the logits of the rows served, and the
    cache positions their tokens wrote.  A launch's rows route
    together; padding rows (token 0 at every position: near-ties among
    themselves, broken by the packages' last bits) are garbage in both
    and are not compared."""
    params, tree, cfg_j, cfg = model_pair
    model = params_from_numpy(tree, cfg, device=CPU)
    f32 = dict(compute_dtype=jnp.float32)
    t32 = dict(compute_dtype=torch.float32)
    static = ("cfg", "max_len", "compute_dtype")
    JT_prefill, JT_padded = (jax.jit(f, static_argnames=static)
                             for f in (JT.prefill, JT.prefill_padded))
    JT_extend, JT_decode = (jax.jit(f, static_argnames=static[::2])
                            for f in (JT.prefill_extend, JT.decode_step))
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = JT_prefill(params, jnp.asarray(tokens), cfg=cfg_j, max_len=16,
                      **f32)
    got = T.prefill(model, tokens, cfg, max_len=16, **t32)
    _close(got[0], want[0], "prefill logits")
    _close_cache(got[1], want[1], cfg)

    tokens, lengths = _padded(rng, [3, 9, 16, 0], 16, cfg.vocab_size)
    jl, jc = JT_padded(params, jnp.asarray(tokens), jnp.asarray(lengths),
                       cfg=cfg_j, max_len=32, **f32)
    tl, tc = T.prefill_padded(model, tokens, lengths, cfg, max_len=32, **t32)
    _close(tl[:3], np.asarray(jl)[:3], "prefill_padded logits")
    _close_rows(tc, jc, cfg, [slice(0, n) for n in lengths])

    suffix, slen = _padded(rng, [8, 3, 0, 5], 8, cfg.vocab_size)
    offsets = np.array([16, 9, 0, 4], np.int32)
    jl, jc2 = JT_extend(params, jnp.asarray(suffix), jnp.asarray(slen),
                        jnp.asarray(offsets), jc, cfg=cfg_j, **f32)
    tl, tc = T.prefill_extend(model, suffix, slen, offsets,
                              _port_cache(jc, cfg), cfg, **t32)
    live = [b for b in range(4) if slen[b]]
    _close(tl[live], np.asarray(jl)[live], "prefill_extend logits")
    _close_rows(tc, jc2, cfg, [slice(o, o + n) for o, n in
                               zip(offsets, slen)])

    jc = jc2
    for pos in (24, 25):
        step = rng.integers(4, cfg.vocab_size, (4, 1)).astype(np.int32)
        jl, jc_next = JT_decode(params, jnp.asarray(step), jc,
                                jnp.int32(pos), cfg=cfg_j, **f32)
        tl, tc = T.decode_step(model, step, _port_cache(jc, cfg), pos, cfg,
                               **t32)
        _close(tl, jl, f"decode logits at {pos}")
        _close_cache(tc, jc_next, cfg)
        jc = jc_next


def test_make_kv_cache_maps_to_the_reference_layout(model_pair):
    _, _, cfg_j, cfg = model_pair
    want = JT.make_kv_cache(cfg_j, 3, 16, jnp.float32)
    got = T.make_kv_cache(cfg, 3, 16, torch.float32, device="cpu")
    bs = T.block_size(cfg)
    assert len(want) == bs
    for name in ("k", "v"):
        assert got[name].shape[0] == cfg.n_layers
        for j in range(bs):
            assert tuple(got[name][j::bs].shape) == want[j][name].shape


# ---------------------------------------------------------------------------
# the engine on a tiny MoE recipe
# ---------------------------------------------------------------------------
# the recipe's width with 4 experts: deepseek-style (top-2, a shared
# expert, every layer MoE) and maverick-style ([dense, moe] blocks)
ENGINE_MOE = {
    "deepseek": dict(family="lm-moe", moe=dict(n_experts=4, top_k=2,
                                              n_shared=1, d_ff_expert=32)),
    "maverick": dict(family="lm-moe", moe_every=2,
                     moe=dict(n_experts=4, top_k=1, n_shared=1,
                              d_ff_expert=64)),
}
PROMPTS = [
    "alpha beta",
    "tell me about alpha beta",
    "gamma delta question",
    "a considerably longer question that lands in a larger padded "
    "bucket than the short prompts do",
    "epsilon zeta words",
]


def _overrides(style, port):
    kw = dict(ENGINE_MOE[style])
    kw["moe"] = (MoEConfig if port else JaxMoEConfig)(**kw["moe"])
    return kw


# the JAX ``make_test_engine`` recipe's config (``serving/testing.py``)
RECIPE = dict(name="t", family="lm-dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
              max_seq_len=128)


@functools.lru_cache(maxsize=None)
def _recipe(style):
    """The recipe's JAX config with the style's MoE, and its
    ``init_params`` weights (key 0, drawn under ``jax.jit``)."""
    cfg_j = JaxLMConfig(**dict(RECIPE, **_overrides(style, False)))
    params = jax.jit(lambda k: JT.init_params(cfg_j, k)[0])(
        jax.random.PRNGKey(0))
    return cfg_j, params, jax.tree.map(np.asarray, params)


def _engines(style, **kw):
    """A JAX ``Engine`` and the port's ``make_test_engine`` on the same
    recipe and weights; ``check()`` holds them launch by launch."""
    cfg_j, params, tree = _recipe(style)
    ecfg = dict(max_batch=2, max_seq_len=64, max_new_tokens=6)
    ecfg.update(kw)
    je = share_launches(JaxEngine(cfg_j, params, JaxEngineConfig(**ecfg)))
    pe = make_test_engine(device="cpu", params=tree, **ecfg,
                          **_overrides(style, True))
    want, got = Launches(je, port=False), Launches(pe, port=True)
    return je, pe, lambda: got.assert_matches(want)


@pytest.mark.parametrize("style", sorted(ENGINE_MOE))
def test_moe_engine_matches_reference(style):
    """A batch in several buckets, then prefix hits, on one engine."""
    je, pe, check = _engines(style, max_batch=3, prefix_cache_entries=4)
    assert pe.cfg.is_moe and any(layer.is_moe for layer in pe.model.layers)
    want = je.generate_batch(PROMPTS)
    got = pe.generate_batch(PROMPTS)
    assert got == want
    ctx = "The capital of France is Paris and the river is Seine . "
    prefix = f"Context:\n{ctx}\n\n"
    prompts = [prefix + f"Question: q{i} capital\nAnswer:" for i in range(5)]
    want = je.generate_batch(prompts, prefixes=[prefix] * 5)
    got = pe.generate_batch(prompts, prefixes=[prefix] * 5)
    assert got == want and pe.stats == je.stats
    assert pe.stats["prefix_hits"] > 0
    check()


@pytest.mark.parametrize("style", sorted(ENGINE_MOE))
def test_moe_engine_slot_reuse_and_two_length_groups(style):
    """A slot reused after a longer occupant, while two groups decode at
    different lengths: every row of every launch (padding, idle slots,
    the cache positions past a row's frontier) must be the reference's,
    since garbage rows take expert capacity from served ones."""
    je, pe, check = _engines(style, max_batch=3, max_new_tokens=8)
    long_first = ["a considerably longer question that lands in a larger "
                  "padded bucket than the short prompts do and then some "
                  "more words"]
    for eng in (je, pe):
        eng.generate_batch(long_first, max_new_tokens=12)
    for prompts in (["alpha beta", "gamma delta question"],
                    ["tell me about alpha beta", "epsilon zeta words",
                     "eta"]):
        for budget in (3, 8):
            want = je.generate_batch(prompts, max_new_tokens=budget)
            got = pe.generate_batch(prompts, max_new_tokens=budget)
            assert got == want
    # submitted between steps: admissions land while other slots decode
    # at other lengths
    outs = []
    for eng in (je, pe):
        rids = [eng.submit(PROMPTS[3], 8)]
        eng.step()
        rids.append(eng.submit(PROMPTS[0], 5))
        eng.step()
        eng.step()
        rids.append(eng.submit(PROMPTS[1], 6))
        eng.run_until_done()
        outs.append([eng._results.pop(r) for r in rids])
    assert outs[1] == outs[0]
    assert pe.stats == je.stats
    check()
