"""The JAX package's serving engines, their compiled launches shared.

``repro.serving.engine.Engine`` makes its three launches
(``_prefill_bucket``, ``_decode_step``, ``_prefill_extend``) new
``jax.jit`` callables, so each engine compiles every shape again.  They
read nothing of the engine but its ``LMConfig`` and the ``EngineConfig``'s
``max_seq_len`` and ``compute_dtype``, and take the weights, tokens and
caches as arguments.  ``share_launches`` gives an engine the callables
of the first engine seen with the same three, so each shape compiles
once a process; the engine is otherwise its own (queue, slots, prefix
cache, ``stats``).
"""
from repro.serving.testing import make_test_engine

_LAUNCHES = ("_prefill_bucket", "_decode_step", "_prefill_extend")
_SHARED = {}


def share_launches(engine):
    key = (engine.cfg, engine.ecfg.max_seq_len, engine.ecfg.compute_dtype)
    first = _SHARED.setdefault(key, {n: getattr(engine, n)
                                     for n in _LAUNCHES})
    for name, fn in first.items():
        setattr(engine, name, fn)
    return engine


def jax_engine(**kw):
    """``make_test_engine(**kw)`` with shared launches."""
    return share_launches(make_test_engine(**kw))
