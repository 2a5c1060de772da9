"""Port vs JAX: the ``PolicyStore``'s pins and lagged resolution, and the
``ServeEngine``'s in-flight weight swap, at
``reduced_config("qwen2.5-0.5b")``.

* The store is driven through the same publish / quarantine / pin /
  release scripts as ``repro.runtime.PolicyStore``: every read, and
  every error's type, equal (params exactly).
* The port's ring is written in place, where JAX's arrays are
  immutable: a version that is pinned, or that an engine holds, must
  compute as itself after ``capacity`` further publishes overwrite its
  slot (logits within 1e-6 of a clone taken before: the same tensors'
  values, so in fact exact).
* An engine over a store, with publishes between steps, against the JAX
  engine on the same weights (greedy, and sampled with the JAX engine's
  Gumbel noise replayed): tokens, per-token versions, swaps, the
  swap-to-stale histogram's count and the tracer's events equal;
  ``log_beta`` within 1e-5 of max(1, its largest magnitude), as for the
  other x3-scaled weights' log-probs in ``test_torch_train.py``
  (float32 matmuls in another order; sampled log-probs reach -5.6).

The reference's own swap tests are not the yardstick (ROADMAP C2): the
port is held to the reference's outputs on the same inputs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data.tokenizer import get_tokenizer
from repro.metrics.runtime_metrics import \
    collect_serve_stats as jax_collect_serve_stats
from repro.models.registry import build as jax_build
from repro.obs.tracer import Tracer as JaxTracer
from repro.runtime import PolicyStore as JaxPolicyStore
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import reduced_config
from repro_torch.metrics import collect_serve_stats
from repro_torch.models.registry import build
from repro_torch.obs.tracer import Tracer
from repro_torch.runtime import PolicyStore
from repro_torch.serve import ServeEngine
from repro_torch.utils.bridge import from_jax_params
from repro_torch.utils.tree import tree_leaves, tree_map

from test_torch_serve import _ReplayJaxNoise

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
PROMPTS = ["12+345=?#", "998-76=?#" * 2, "7*8=?#", "1+1=?#"]
BUDGETS = [14, 10, 16, 12]
ENGINE_KW = dict(num_blocks=32, block_size=4, max_batch=3, max_seq_len=64,
                 decode_chunk=2, prefill_chunk=8, dispatch_budget=12)


def _scaled_init(seed):
    """JAX init with dense weights scaled x3 (so random-init greedy
    output varies), and its port twin."""
    params = jax_build(JCFG).init(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 3.0 if "'w'" in jax.tree_util.keystr(p) else a,
        params)
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def versions():
    """Four policies: the store's init and three to publish."""
    return [_scaled_init(seed) for seed in range(4)]


# ---------------------------------------------------------------------------
# (a) the store against the reference's store
# ---------------------------------------------------------------------------

_J0 = {"w": np.zeros((2, 3), np.float32)}
_SCRIPTS = {
    # tests/test_speculative.py's pin/release refcount, extended.
    "pin_release": [("publish", 1.0), ("pin", 0), ("pin", 0),
                    ("publish", 2.0), ("retained",), ("get", 0),
                    ("pinned",), ("resolve", -2), ("release", 0),
                    ("get", 0), ("release", 0), ("get", 0), ("release", 0),
                    ("pinned",), ("pin", 0), ("get", 7), ("pin", 7)],
    "resolve_lagged": [("publish", 1.0), ("publish", 2.0), ("publish", 3.0),
                       ("resolve", 0), ("resolve", -1), ("resolve", -3),
                       ("pin", 2), ("publish", 4.0), ("resolve", -2),
                       ("resolve", -9), ("resolve", 1), ("retained",),
                       ("get", 2), ("get", 1)],
    "pin_lagged": [("publish", 1.0), ("pin_lagged", -1), ("pinned",),
                   ("publish", 2.0), ("pin_lagged", -10), ("get", 0),
                   ("release", 0), ("release", 0), ("pin_lagged", 1),
                   ("pinned",), ("get", 0)],
    "quarantine": [("publish", 1.0), ("publish", float("nan")),
                   ("latest",), ("resolve", 0), ("get", 2), ("pin", 2),
                   ("quarantine", 1), ("resolve", 0), ("pin_lagged", 0),
                   ("publish", 3.0), ("latest",), ("resolve", -1),
                   ("get", 1), ("quarantine", 9), ("pinned",)],
}


def _drive(store, script, to_np, make):
    """Run ``script`` on ``store``; every result (params as numpy) or the
    error's class name, in order."""
    log = []
    for op, *args in script:
        try:
            if op == "publish":
                out = store.publish(make(args[0]))
            elif op == "get":
                out = to_np(store.get(args[0]))
            elif op == "pin":
                out = to_np(store.pin(args[0]))
            elif op == "pin_lagged":
                params, version = store.pin_lagged(args[0])
                out = (to_np(params), version)
            elif op == "latest":
                params, version = store.latest()
                out = (to_np(params), version)
            elif op == "resolve":
                out = store.resolve_lagged(args[0])
            elif op == "release":
                out = store.release(args[0])
            elif op == "quarantine":
                out = store.quarantine(args[0])
            elif op == "pinned":
                out = store.pinned_versions()
            else:
                out = store.retained_versions()
        except Exception as e:          # the error taxonomy is compared
            out = ("raised", type(e).__name__)
        log.append((op, args, out))
    return log


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_store_pins_and_resolution_match_jax(script):
    steps = _SCRIPTS[script]
    want = _drive(
        JaxPolicyStore(jax.tree.map(jax.numpy.asarray, _J0), capacity=2,
                       guard_finite=True), steps,
        lambda p: np.asarray(p["w"]).tolist(),
        lambda x: {"w": jax.numpy.full((2, 3), x, jax.numpy.float32)})
    got = _drive(
        PolicyStore({"w": torch.zeros(2, 3)}, capacity=2,
                    guard_finite=True), steps,
        lambda p: p["w"].numpy().tolist(),
        lambda x: {"w": torch.full((2, 3), x)})
    assert got == want
    assert any(isinstance(o, tuple) and o[:1] == ("raised",)
               for _, _, o in want)      # the script reaches errors


# ---------------------------------------------------------------------------
# (b) a held or pinned version survives the overwrite of its ring slot
# ---------------------------------------------------------------------------


def _logits(params):
    tokens = torch.from_numpy(np.asarray(
        [TOK.encode("12+34=?#"), TOK.encode("9*9=?#12")], np.int32))
    with torch.no_grad():
        return build(CFG).forward(params, tokens).logits


@pytest.mark.parametrize("reader", ["pin", "pin_lagged", "engine"])
def test_held_version_survives_its_slot_overwrite(versions, reader):
    """At capacity 2, three publishes overwrite version 0's slot (and
    then its successor's) while a pin or an engine under
    ``swap_interval=0`` still reads version 0."""
    store = PolicyStore(tree_map(torch.clone, versions[0][1]), capacity=2)
    stale_view = None
    if reader == "pin":
        params = store.pin(0)
    elif reader == "pin_lagged":
        params, v = store.pin_lagged(-5)
        assert v == 0
    else:
        eng = ServeEngine(build(CFG), store=store, swap_interval=0,
                          temperature=0.0, device="cpu", **ENGINE_KW)
        params = eng.params
        stale_view = store.get(0)      # an unheld view of the same slot
    before = _logits(tree_map(torch.clone, params))
    for _, p in versions[1:]:
        store.publish(p)
    assert store.retained_versions() == [2, 3]
    ring = {t.untyped_storage().data_ptr()
            for t in tree_leaves(store.buffer.stacked)}
    assert not ring & {t.untyped_storage().data_ptr()
                       for t in tree_leaves(params)}
    torch.testing.assert_close(_logits(params), before, rtol=0, atol=1e-6)
    if reader == "engine":
        assert eng.version == 0 and store.pinned_versions() == []
        assert store.resolve_lagged(-3) == 2   # a hold is no pin
        # Without the hold the slot's old view reads a later version.
        assert (_logits(stale_view) - before).abs().max() > 1e-2
        for i, prompt in enumerate(PROMPTS):
            eng.submit(np.asarray(TOK.encode(prompt), np.int32), 4,
                       request_id=i)
        ref = ServeEngine(build(CFG), versions[0][1], device="cpu",
                          temperature=0.0, **ENGINE_KW)
        for i, prompt in enumerate(PROMPTS):
            ref.submit(np.asarray(TOK.encode(prompt), np.int32), 4,
                       request_id=i)
        got = {t.request_id: t.tokens.tolist() for t in eng.run(100)}
        assert got == {t.request_id: t.tokens.tolist() for t in ref.run(100)}
    else:
        assert store.pinned_versions() == [0]
        assert store.get(0) is params


def test_engine_refuses_a_store_on_another_device(versions):
    store = PolicyStore(tree_map(lambda t: t.to("meta"), versions[0][1]),
                        capacity=2)
    with pytest.raises(ValueError, match="device"):
        ServeEngine(build(CFG), store=store, device="cpu", **ENGINE_KW)


# ---------------------------------------------------------------------------
# (c) in-flight swap against the JAX engine
# ---------------------------------------------------------------------------


def _serve_with_publishes(eng, store, new_params, publish_at):
    """Submit the prompts, step until drained, publishing
    ``new_params[k]`` before step ``publish_at[k]``."""
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(np.asarray(TOK.encode(p), np.int32), b, request_id=i)
    out, step = {}, 0
    pending = list(zip(publish_at, new_params))
    while eng.has_work:
        if pending and pending[0][0] == step:
            store.publish(pending.pop(0)[1])
        out.update({t.request_id: t for t in eng.step()})
        step += 1
        assert step < 300
    assert not pending
    return out


@pytest.mark.parametrize("swap_interval", [1, 3])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_inflight_swap_matches_jax(versions, swap_interval, temperature):
    publish_at = [2, 5]
    kw = dict(ENGINE_KW, temperature=temperature, seed=3,
              swap_interval=swap_interval)
    jstore = JaxPolicyStore(versions[0][0], capacity=2)
    jax_tracer, tracer = JaxTracer(detail="full"), Tracer(detail="full")
    jeng = JaxServeEngine(jax_build(JCFG), store=jstore, tracer=jax_tracer,
                          **kw)
    want = _serve_with_publishes(jeng, jstore,
                                 [v[0] for v in versions[1:3]], publish_at)
    store = PolicyStore(versions[0][1], capacity=2)
    eng = ServeEngine(build(CFG), store=store, tracer=tracer, device="cpu",
                      **kw)
    if temperature > 0:
        _ReplayJaxNoise(eng, 3, temperature, 1.0)
    got = _serve_with_publishes(eng, store, [v[1] for v in versions[1:3]],
                                publish_at)
    assert sorted(got) == sorted(want) == list(range(len(PROMPTS)))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        np.testing.assert_array_equal(got[rid].versions, want[rid].versions)
        w = want[rid].log_beta
        assert np.abs(got[rid].log_beta - w).max() <= 1e-5 * max(
            1.0, np.abs(w).max())
        assert got[rid].finish_reason == want[rid].finish_reason
    # A swap lands inside at least one request, or nothing was tested.
    assert any(len(set(t.versions.tolist())) > 1 for t in want.values())
    assert eng.stats.swaps == jeng.stats.swaps == 2
    assert eng.version == jeng.version == 2
    # The swap is a pointer change: the engine serves the ring's tensors.
    ring = {t.untyped_storage().data_ptr()
            for t in tree_leaves(store.buffer.stacked)}
    assert {t.untyped_storage().data_ptr()
            for t in tree_leaves(eng.params)} <= ring
    stats, jstats = collect_serve_stats(eng), jax_collect_serve_stats(jeng)
    assert set(stats) == set(jstats)
    for key in ("swaps", "steps", "tokens_out", "swap_to_stale_count",
                "policy_version"):
        assert stats[key] == jstats[key], key
    assert stats["swap_to_stale_count"] == 2

    def strip(tr):
        return [(e.ph, e.name, e.pid, e.tid, e.id, e.args)
                for e in tr.events()]

    events = strip(tracer)
    assert events == strip(jax_tracer)
    assert sum(e[1] == "swap" for e in events) == 2
    # A publish lands before a step; at interval 1 that step swaps at
    # once, at 3 the engine runs behind until its next poll.
    lagged = {e[1] for e in events
              if e[1] in ("policy_lag", "token") and e[5]["lag"] > 0}
    assert lagged == ({"policy_lag", "token"} if swap_interval > 1
                      else set())
