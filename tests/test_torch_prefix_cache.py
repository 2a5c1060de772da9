"""Port vs JAX: the prefix cache in the ``ServeEngine``, its launcher
flags and the RLVR serve producer's engine options.

``copy_page_rows`` against JAX's; best-of-N serving (greedy, plain and
speculative) token-exact against the unshared engine and the JAX
engine, with JAX's prefill rows, copy-on-write copies, prefix hits and
hit rates; preemption churn; the version salt invalidating entries
after an in-flight swap; window reclamation; the write-page guard on a
forged refcount; ``serve --runtime versioned --speculate 2
--prefix-cache --best-of 4`` against the JAX launcher's printout; and
``RLVRTrainer(producer="serve", engine_prefix_cache=True,
engine_speculate_k=2)`` against the JAX trainer, item by item.  The JAX
engine's draws are replayed into the port (``_ReplayJaxNoise``)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.metrics.runtime_metrics import \
    collect_serve_stats as jax_collect_serve_stats
from repro.models.registry import build as jax_build
from repro.models.transformer import copy_page_rows as jax_copy_page_rows
from repro.runtime import PolicyStore as JaxPolicyStore
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.metrics import collect_serve_stats
from repro_torch.models.registry import build
from repro_torch.models.transformer import copy_page_rows
from repro_torch.runtime import PolicyStore
from repro_torch.serve import ServeEngine
from repro_torch.train import RLVRHyperparams, RLVRTrainer
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves
from test_torch_serve import _ReplayJaxNoise

torch.set_num_threads(1)

TOK = get_tokenizer()
CFG_KW = dict(name="prefix-test", arch_type="dense", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=TOK.vocab_size)
JAX_BUNDLE = jax_build(JaxModelConfig(**CFG_KW))
BUNDLE = build(ModelConfig(**CFG_KW))
# Both layers windowed (window 6): pages behind it are reclaimed.
WIN_KW = dict(CFG_KW, name="prefix-window-test", sliding_window=6,
              global_every=5)
JAX_WIN_BUNDLE = jax_build(JaxModelConfig(**WIN_KW))
WIN_BUNDLE = build(ModelConfig(**WIN_KW))
PROMPTS = [np.asarray(TOK.encode(p), np.int32)
           for p in ("12+345=?#", "998-76=?#")]
GREEDY = 1e-4                     # the JAX tests' greedy temperature
ENGINE_KW = dict(num_blocks=64, block_size=4, max_batch=4, max_seq_len=64,
                 temperature=GREEDY, seed=0)
PREFIX_STATS = ("prefill_tokens", "cow_copies", "prefix_hits",
                "prefix_queries", "prefix_hit_rate", "prefix_matched_tokens",
                "prefix_token_hit_rate", "cached_pages", "cache_evictions",
                "prefills", "prefill_dispatches", "preemptions", "steps",
                "spec_rounds", "drafted_tokens", "accepted_tokens",
                "tokens_out", "pool_blocks_free")


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_sync_dispatch():
    """The JAX serve engine with the prefix cache and speculation on
    gives tokens that differ from run to run under the CPU's
    asynchronous dispatch, and the same tokens every run without it
    (ROADMAP C2), so the reference runs synchronously in this module."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def weights():
    jp = JAX_BUNDLE.init(jax.random.PRNGKey(0))
    jw = JAX_WIN_BUNDLE.init(jax.random.PRNGKey(1))
    return {"jax": jp, "port": _port(jp), "jax_win": jw, "port_win": _port(jw)}


def test_copy_page_rows_matches_jax():
    """Pairs with 0, some and all rows, a page copied on after it was
    written (pairs apply in order), over [L, KV, NB, BS, Dh] pools."""
    rng = np.random.default_rng(0)
    shape = (2, 2, 6, 4, 8)
    pools = {k: rng.normal(size=shape).astype(np.float32)
             for k in ("k_pages", "v_pages")}
    src = np.asarray([1, 3, 0, 2, 5], np.int32)
    dst = np.asarray([2, 4, 5, 3, 1], np.int32)
    rows = np.asarray([3, 4, 0, 1, 2], np.int32)
    want = jax_copy_page_rows(jax.tree.map(jax.numpy.asarray, pools),
                              *(jax.numpy.asarray(a) for a in
                                (src, dst, rows)))
    got = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out = copy_page_rows(got, src, dst, rows)
    assert out is got                                   # in place
    for k in pools:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert not np.array_equal(got[k].numpy(), pools[k])


def _best_of(eng, n=4, budget=8, prompts=PROMPTS):
    """Each prompt submitted ``n`` times; returns {request_id: tokens}."""
    rid = 0
    for p in prompts:
        for _ in range(n):
            eng.submit(p, budget, request_id=f"r{rid}")
            rid += 1
    return {t.request_id: np.asarray(t.tokens)
            for t in eng.run(max_steps=600)}


def _engines(weights, prefix, speculate=0, bundles=None, wkey="", **kw):
    """The JAX engine and the port's (JAX's draws replayed)."""
    jb, b = bundles or (JAX_BUNDLE, BUNDLE)
    ekw = dict(ENGINE_KW, prefix_cache=prefix)
    ekw.update(kw)
    jkw, tkw = dict(ekw), dict(ekw)
    if speculate:
        jkw.update(speculate_k=speculate,
                   draft=("params", weights["jax" + wkey]))
        tkw.update(speculate_k=speculate,
                   draft=("params", weights["port" + wkey]))
    jeng = JaxServeEngine(jb, weights["jax" + wkey], **jkw)
    eng = ServeEngine(b, weights["port" + wkey], device="cpu", **tkw)
    _ReplayJaxNoise(eng, ekw["seed"], ekw["temperature"], 1.0)
    return jeng, eng


def _assert_same_serving(jeng, eng, want, got):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    st, jst = collect_serve_stats(eng), jax_collect_serve_stats(jeng)
    assert set(st) == set(jst)
    for key in PREFIX_STATS:
        assert st[key] == jst[key], key
    assert eng.allocator.num_free == eng.allocator.num_blocks
    return st


@pytest.mark.parametrize("speculate", [0, 3])
def test_best_of_matches_jax_and_the_unshared_engine(weights, speculate):
    jeng, eng = _engines(weights, True, speculate)
    want, got = _best_of(jeng), _best_of(eng)
    st = _assert_same_serving(jeng, eng, want, got)
    # Token-exact with the unshared port engine, at a fraction of its
    # prefill rows: N dense prefills collapse to ~1 a prompt.
    plain = ServeEngine(BUNDLE, weights["port"], device="cpu",
                        **dict(ENGINE_KW, speculate_k=speculate,
                               draft=("params", weights["port"])
                               if speculate else None))
    unshared = _best_of(plain)
    for rid in unshared:
        np.testing.assert_array_equal(got[rid], unshared[rid])
    assert st["prefill_tokens"] < sum(len(p) for p in PROMPTS) * 2
    assert plain.stats.prefill_tokens == 4 * sum(len(p) for p in PROMPTS)
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0
    assert len({int(t) for r in got.values() for t in r}) > 3
    if speculate:
        assert st["accepted_tokens"] == st["drafted_tokens"] > 0


def test_preemption_churn_matches_jax(weights):
    """A pool too small for the stream: preempt / re-admit cycles
    through the cache (eviction under pressure included)."""
    kw = dict(num_blocks=10, max_batch=3, max_seq_len=48)
    jeng, eng = _engines(weights, True, **kw)
    want = _best_of(jeng, n=3, budget=10)
    got = _best_of(eng, n=3, budget=10)
    st = _assert_same_serving(jeng, eng, want, got)
    assert st["preemptions"] > 0


def test_version_salt_invalidates_after_swap_like_jax(weights):
    """After a publish the v0-salted entries are unreachable: no hit,
    and the post-swap request equals a fresh engine on the new weights."""
    p2 = jax.tree.map(lambda x: x + 0.01, weights["jax"])
    out = []
    for store, eng_cls, b, kw in (
            (JaxPolicyStore(weights["jax"], capacity=4), JaxServeEngine,
             JAX_BUNDLE, {}),
            (PolicyStore(weights["port"], capacity=4), ServeEngine, BUNDLE,
             {"device": "cpu"})):
        eng = eng_cls(b, store=store, prefix_cache=True,
                      **dict(ENGINE_KW, max_batch=2), **kw)
        if kw:
            _ReplayJaxNoise(eng, 0, GREEDY, 1.0)
        eng.submit(PROMPTS[0], 6, request_id="warm")
        eng.run(max_steps=200)
        hits = eng.scheduler.prefix_hits
        store.publish(p2 if not kw else _port(p2))
        eng.submit(PROMPTS[0], 6, request_id="postswap")
        (traj,) = eng.run(max_steps=200)
        assert eng.scheduler.prefix_hits == hits
        assert traj.versions.tolist() == [1] * traj.num_tokens
        out.append(traj.tokens)
    np.testing.assert_array_equal(out[1], out[0])
    fresh = ServeEngine(BUNDLE, _port(p2), device="cpu",
                        **dict(ENGINE_KW, max_batch=2))
    fresh.submit(PROMPTS[0], 6)
    (want,) = fresh.run(max_steps=200)
    np.testing.assert_array_equal(out[1], want.tokens)


def test_window_reclamation_matches_jax(weights):
    """Every layer windowed: pages behind the window go back to the
    pool mid-flight; tokens equal the non-reclaiming engine's and the
    JAX engine's, with JAX's reclaimed-page count."""
    kw = dict(num_blocks=32, max_batch=2, bundles=(JAX_WIN_BUNDLE,
                                                   WIN_BUNDLE), wkey="_win")
    outs = {}
    for reclaim in (False, True):
        jeng, eng = _engines(weights, False, window_reclaim=reclaim, **kw)
        outs[reclaim] = []
        for e in (jeng, eng):
            for i, p in enumerate(PROMPTS):
                e.submit(p, 14, request_id=f"w{i}")
            outs[reclaim].append({t.request_id: np.asarray(t.tokens)
                                  for t in e.run(max_steps=400)})
            assert e.allocator.num_free == e.allocator.num_blocks
    assert eng._reclaim_window == 6
    assert eng.scheduler.reclaimed_pages == jeng.scheduler.reclaimed_pages > 0
    want = outs[False][0]
    for got in (outs[False][1], outs[True][0], outs[True][1]):
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


def test_write_page_guard_raises_on_a_forged_refcount(weights):
    """A decode write page whose refcount is not 1 (a refcount or
    copy-on-write bug) stops the step, in both engines."""
    for eng in _engines(weights, True):
        for p in PROMPTS:
            eng.submit(p, 12)
        while not any(r.prefill_done for r in eng.scheduler.running):
            eng.step()
        eng.step()                                    # the guard passes
        req = next(r for r in eng.scheduler.running if r.prefill_done)
        page = req.blocks[int(eng._pos[req.slot]) // eng.block_size]
        eng.allocator._refs[page] += 1                # the forgery
        with pytest.raises(RuntimeError, match="copy-on-write invariant"):
            eng.step()


def _launch(module, argv, capsys):
    assert module.main(argv) in (0, None)
    return capsys.readouterr().out


def test_launcher_speculate_prefix_cache_matches_jax(capsys):
    """``serve --runtime versioned --speculate 2 --prefix-cache --best-of
    4``: the port's printout carries the JAX launcher's prefix-cache and
    speculation lines, number for number (v0 drafts for itself, so every
    token is accepted; the counts depend on prompts and lifetimes, not
    on the two packages' different random inits)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    argv = ["--engine", "continuous", "--runtime", "versioned",
            "--speculate", "2", "--prefix-cache", "--best-of", "4",
            "--requests", "2", "--max-new-tokens", "6", "--temperature", "0"]
    want = _launch(jax_serve, argv, capsys)
    got = _launch(serve, argv + ["--device", "cpu"], capsys)

    def lines(out, head):
        return [ln.strip() for ln in out.splitlines()
                if ln.strip().startswith(head)]

    for head in ("prefix cache:", "speculative k=2:", "occupancy"):
        g, w = lines(got, head), lines(want, head)
        assert len(g) == len(w) == 1, head
        if head == "occupancy":     # up to the wall-clock latencies
            g, w = [g[0].split(" latency")[0]], [w[0].split(" latency")[0]]
        assert g == w, head
    assert "acceptance 1.00 (38/38 drafted), draft v0" in got
    assert "hit rate 0.88 (7/8 admissions)" in got
    tags = [ln.rsplit(" ", 2)[-1] for ln in lines(got, "[")]
    assert tags == [ln.rsplit(" ", 2)[-1] for ln in lines(want, "[")]
    assert len(tags) == 8 and set(tags) == {"v0]"}


JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)


def test_serve_rlvr_trainer_with_prefix_cache_and_speculation_matches_jax():
    """``RLVRTrainer(producer="serve", forced_lag=2, engine_prefix_cache=
    True, engine_speculate_k=2)``: 2 warmup steps, one phase of 2
    minibatches against the JAX trainer (phase logs and params within
    1e-4 as in ``test_torch_serve_producer.py``), each item's tokens,
    mask, versions, rewards and log_beta (1e-5), the same queue stats,
    and the engine's prefix and speculation counts equal to JAX's.  Each
    prompt's GRPO group of 4 shares its prefill."""
    kw = dict(algorithm="grpo_vaco", n_minibatches=2, warmup_steps=2,
              producer="serve", forced_lag=2, engine_prefix_cache=True,
              engine_speculate_k=2)
    jtr = JaxRLVRTrainer(jax_build(JCFG),
                         JaxMathTaskDataset(prompt_len=32, level=0),
                         JHyperparams(**kw), seed=0)
    tr = RLVRTrainer(build(CFG), MathTaskDataset(prompt_len=32, level=0),
                     RLVRHyperparams(**kw), seed=0, device="cpu",
                     params=from_jax_params(
                         jax.tree.map(np.asarray, jtr.state.params)))
    _ReplayJaxNoise(tr.engine, 2, tr.hp.temperature, 1.0)   # seed + 2
    items = {}
    for name, t in (("jax", jtr), ("port", tr)):
        put, items[name] = t.queue.put, []
        t.queue.put = lambda mb, _p=put, _i=items[name], **k: (
            _i.append(mb), _p(mb, **k))[1]
    assert abs(tr.warmup() - jtr.warmup()) <= 1e-4
    want, got = jtr.train_phase(), tr.train_phase()
    assert len(got) == len(want) == 2
    assert len(items["port"]) == len(items["jax"]) == 2
    for g, w in zip(items["port"], items["jax"]):
        np.testing.assert_array_equal(g.gen.tokens.numpy(),
                                      np.asarray(w.gen.tokens))
        np.testing.assert_array_equal(g.gen.mask.numpy(),
                                      np.asarray(w.gen.mask))
        np.testing.assert_array_equal(g.versions, np.asarray(w.versions))
        np.testing.assert_allclose(g.gen.log_beta.numpy(),
                                   np.asarray(w.gen.log_beta), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.rewards.numpy(),
                                      np.asarray(w.rewards))
    for g, w in zip(got, want):
        assert g.mean_reward == w.mean_reward
        assert g.staleness == w.staleness
        assert g.filter_active == w.filter_active
        for key in ("weight", "tv", "frac_filtered"):
            assert abs(getattr(g, key) - getattr(w, key)) <= 1e-4, key
    for g, w in zip(tree_leaves(to_numpy(tr.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jtr.state.params))):
        assert np.abs(g - w).max() <= 1e-4
    assert tr.queue.stats().as_dict() == jtr.queue.stats().as_dict()
    st = collect_serve_stats(tr.engine)
    jst = jax_collect_serve_stats(jtr.engine)
    for key in PREFIX_STATS + ("draft_version",
                               "draft_version_lag_histogram"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] > 0 and st["drafted_tokens"] > 0
    assert tr.store.pinned_versions() == jtr.store.pinned_versions()
