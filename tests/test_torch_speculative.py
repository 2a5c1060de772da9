"""Port vs JAX: speculative decode in the ``ServeEngine``.

The accept rule (``rollout.sampler.speculative_accept``) on JAX's own
draws; the engine against the JAX engine at the JAX tests' sizes (2
layers, d 64) for every draft kind, with the JAX engine's PRNG draws
replayed into the port (``_ReplayJaxNoise``): equal tokens and equal
speculation counts, the adversarial draft included (it accepts 1 of
its 68 drafted tokens there, and auto-disables), the adaptive chosen-k
histograms and the EMA reset on admission, rollback under preemption,
sampled serving (``log_beta`` within 1e-5 of JAX's and of the port's
own re-scoring) and self-speculation over a ``PolicyStore`` (versions,
pins and stats, with and without private weights)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.data.tokenizer import PAD, get_tokenizer
from repro.metrics.runtime_metrics import \
    collect_serve_stats as jax_collect_serve_stats
from repro.models.registry import build as jax_build
from repro.rollout.sampler import speculative_accept as jax_accept
from repro.runtime import PolicyStore as JaxPolicyStore
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.metrics import collect_serve_stats
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import score_tokens, speculative_accept
from repro_torch.runtime import PolicyStore
from repro_torch.serve import ServeEngine
from repro_torch.utils.bridge import from_jax_params
from test_torch_serve import _ReplayJaxNoise

torch.set_num_threads(1)

TOK = get_tokenizer()
CFG_KW = dict(name="spec-test", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=TOK.vocab_size)
JAX_BUNDLE = jax_build(JaxModelConfig(**CFG_KW))
BUNDLE = build(ModelConfig(**CFG_KW))
# A one-layer draft model of the same vocab (the "model" draft kind).
DRAFT_KW = dict(CFG_KW, name="spec-draft", n_layers=1)
JAX_DRAFT_BUNDLE = jax_build(JaxModelConfig(**DRAFT_KW))
DRAFT_BUNDLE = build(ModelConfig(**DRAFT_KW))
PROMPTS = [np.asarray(TOK.encode(p), np.int32)
           for p in ("1+2=?#", "3*4=?#", "10-7=?#")]
BUDGETS = [5, 9, 13]
GREEDY = 1e-4                     # the JAX tests' greedy temperature
ENGINE_KW = dict(num_blocks=32, block_size=4, max_batch=2, max_seq_len=64,
                 seed=0)


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_sync_dispatch():
    """The JAX serve engine can give tokens that differ from run to run
    under the CPU's asynchronous dispatch (seen with the prefix cache and
    speculation on, ROADMAP C2), so the reference runs synchronously in
    this module."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def weights():
    """The JAX tests' verifier (key 0), adversarial draft (key 99) and a
    one-layer draft model (key 7), each in both packages."""
    jp = JAX_BUNDLE.init(jax.random.PRNGKey(0))
    ja = JAX_BUNDLE.init(jax.random.PRNGKey(99))
    jd = JAX_DRAFT_BUNDLE.init(jax.random.PRNGKey(7))
    return {"jax": jp, "port": _port(jp), "jax_adv": ja, "port_adv": _port(ja),
            "jax_draft": jd, "port_draft": _port(jd)}


# --- the accept rule --------------------------------------------------------


def _peaked(tokens, vocab, hi=8.0):
    return np.where(tokens[..., None] == np.arange(vocab), hi, 0.0
                    ).astype(np.float32)


def _jax_draws(key, b, k, v):
    """The (u, gumbel) pair jax's speculative_accept draws from ``key``."""
    k_u, k_r = jax.random.split(key)
    u = jax.random.uniform(k_u, (b, k), minval=1e-7)
    return (torch.from_numpy(np.array(u)),
            torch.from_numpy(np.array(jax.random.gumbel(k_r, (b, v)))))


def _accept_case(name):
    v = 11
    drafts = np.asarray([[3, 5, 7, 2]], np.int32)
    if name == "accept_all":
        return _peaked(drafts, v), drafts, _peaked(drafts, v), GREEDY, 1.0
    if name == "reject_first":
        return (_peaked(np.asarray([[4, 6, 8, 1]]), v), drafts,
                _peaked(drafts, v), GREEDY, 1.0)
    if name == "partial_prefix":
        return (_peaked(np.asarray([[3, 5, 9, 2]]), v), drafts,
                _peaked(drafts, v), GREEDY, 1.0)
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 3, 17)).astype(np.float32)
    if name == "identical":
        return logits, logits.argmax(-1).astype(np.int32), logits, 1.0, 1.0
    # sampled: a draft near the verifier proposing its own argmax, so
    # some tokens are kept and some corrected; top-p on.
    q = logits + 0.7 * rng.normal(size=(2, 3, 17)).astype(np.float32)
    return logits, q.argmax(-1).astype(np.int32), q, 0.7, 0.9


@pytest.mark.parametrize("name", ["accept_all", "reject_first",
                                  "partial_prefix", "identical", "sampled"])
@pytest.mark.parametrize("seed", [0, 5])
def test_speculative_accept_matches_jax(name, seed):
    verifier, drafts, draft_logits, temp, top_p = _accept_case(name)
    key = jax.random.PRNGKey(seed)
    want = jax_accept(jnp.asarray(verifier), jnp.asarray(drafts),
                      jnp.asarray(draft_logits), key, temperature=temp,
                      top_p=top_p)
    b, k, v = verifier.shape
    got = speculative_accept(
        torch.from_numpy(verifier), torch.from_numpy(drafts),
        torch.from_numpy(draft_logits), *_jax_draws(key, b, k, v),
        temperature=temp, top_p=top_p)
    toks, lps, n_acc, n_emit = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), toks)
    np.testing.assert_array_equal(got[2].numpy(), n_acc)
    np.testing.assert_array_equal(got[3].numpy(), n_emit)
    np.testing.assert_allclose(got[1].numpy(), lps, rtol=0, atol=1e-5)
    # The JAX tests' own facts, on the port.
    n = got[2].numpy()
    if name == "accept_all":
        assert n.tolist() == [4] and got[3].tolist() == [4]
        assert got[0][0].tolist() == [3, 5, 7, 2]
    elif name == "reject_first":
        assert n.tolist() == [0] and got[3].tolist() == [1]
        assert int(got[0][0, 0]) == 4                  # verifier argmax
        assert (got[0][0, 1:] == PAD).all() and (got[1][0, 1:] == 0).all()
    elif name == "partial_prefix":
        assert n.tolist() == [2] and got[0][0, :3].tolist() == [3, 5, 9]
    elif name == "identical":
        assert n.tolist() == [3, 3]
    else:
        assert 0 < int(n.sum()) < 6            # both outcomes are drawn


def test_onehot_draft_marginal_is_the_verifiers():
    """A one-hot proposal still emits tokens distributed as the
    verifier: 4000 rows of the JAX test's case, each on the draws JAX
    takes from its own key, equal to JAX's rows and within 0.03 of
    ``softmax(p)``."""
    v, n = 5, 4000
    verifier = np.asarray([[[0.5, 1.5, -0.3, 0.2, -1.0]]], np.float32)
    drafts = np.asarray([[1]], np.int32)
    onehot = np.where(drafts[..., None] == np.arange(v), 0.0, -1e9
                      ).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax_accept(
        jnp.asarray(verifier), jnp.asarray(drafts), jnp.asarray(onehot), k,
        temperature=1.0)[0][0, 0]))(keys))
    draws = [_jax_draws(k, 1, 1, v) for k in keys]
    u = torch.cat([d[0] for d in draws])
    g = torch.cat([d[1] for d in draws])
    rows = lambda a: torch.from_numpy(a).expand(n, *a.shape[1:])
    got = speculative_accept(rows(verifier), rows(drafts), rows(onehot), u,
                             g, temperature=1.0)[0][:, 0].numpy()
    np.testing.assert_array_equal(got, want)
    p = torch.softmax(torch.from_numpy(verifier[0, 0]), -1).numpy()
    np.testing.assert_allclose(np.bincount(got, minlength=v) / n, p,
                               atol=0.03)


# --- the engine against the JAX engine --------------------------------------


def _drafts(weights, label):
    """(JAX draft, port draft) of each kind the engine takes."""
    if label in ("accept_all", "k1"):
        return ("params", weights["jax"]), ("params", weights["port"])
    if label == "adversarial":
        return ("params", weights["jax_adv"]), ("params", weights["port_adv"])
    if label == "model":
        return (("model", JAX_DRAFT_BUNDLE, weights["jax_draft"]),
                ("model", DRAFT_BUNDLE, weights["port_draft"]))
    fn = lambda req, k: np.zeros(k, np.int32)
    return fn, fn


SPEC_COUNTS = ("steps", "decode_steps", "spec_rounds", "drafted_tokens",
               "accepted_tokens", "spec_autodisables", "prefills",
               "prefill_tokens", "tokens_out", "preemptions",
               "occupancy_sum")


def _pair(weights, label, k, temperature=GREEDY, top_p=1.0, seed=0,
          prompts=PROMPTS, budgets=BUDGETS, **kw):
    """The JAX engine and the port's (JAX's draws replayed) on the same
    requests; returns both engines and both trajectory maps, in
    submission order."""
    jd, td = _drafts(weights, label)
    ekw = dict(ENGINE_KW, temperature=temperature, top_p=top_p, seed=seed,
               speculate_k=k)
    ekw.update(kw)
    jeng = JaxServeEngine(JAX_BUNDLE, weights["jax"], draft=jd, **ekw)
    eng = ServeEngine(BUNDLE, weights["port"], draft=td, device="cpu", **ekw)
    _ReplayJaxNoise(eng, seed, temperature, top_p)
    out = []
    for e in (jeng, eng):
        reqs = [e.submit(r, n) for r, n in zip(prompts, budgets)]
        trajs = {t.request_id: t for t in e.run(max_steps=400)}
        out.append([trajs[r.request_id] for r in reqs])
    return jeng, eng, out[0], out[1]


def _assert_same(jeng, eng, want, got, atol=1e-5):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_allclose(g.log_beta, w.log_beta, rtol=0, atol=atol)
        assert g.finish_reason == w.finish_reason
    for key in SPEC_COUNTS:
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    assert eng.spec_disabled == jeng.spec_disabled
    assert eng.allocator.num_free == eng.allocator.num_blocks


@pytest.mark.parametrize("label,k", [("accept_all", 4), ("adversarial", 4),
                                     ("k1", 1), ("callable", 3)])
def test_spec_engine_matches_jax(weights, label, k):
    jeng, eng, want, got = _pair(weights, label, k)
    _assert_same(jeng, eng, want, got)
    st, jst = collect_serve_stats(eng), jax_collect_serve_stats(jeng)
    assert set(st) == set(jst)
    for key in ("acceptance_rate", "draft_version", "chosen_k_histogram",
                "draft_version_lag_histogram", "spec_disabled"):
        assert st[key] == jst[key], key
    if label == "accept_all":
        assert st["acceptance_rate"] == 1.0
    if label == "adversarial":
        # JAX's own count on these inputs: 1 of 68, then auto-disable.
        assert (eng.stats.accepted_tokens, eng.stats.drafted_tokens) == \
            (jeng.stats.accepted_tokens, jeng.stats.drafted_tokens)
        assert eng.stats.spec_autodisables == 1
    # Greedy output varies (token equality says something).
    assert len({int(t) for r in got for t in r.tokens}) > 3


@pytest.mark.parametrize("label", ["accept_all", "adversarial"])
def test_adaptive_k_matches_jax(weights, label):
    """Adaptive k (``k_max`` 3): JAX's chosen-k histogram and acceptance
    EMAs; then, with the adversarial draft, a new admission resets its
    slot's EMA, so the next round drafts ``k_max`` again."""
    k_max = 3
    # Auto-disable off: the adversarial draft would stop speculation.
    jeng, eng, want, got = _pair(weights, label, k_max,
                                 speculate_adaptive=True,
                                 spec_disable_after=1000)
    _assert_same(jeng, eng, want, got)
    hist = eng._chosen_k_hist.snapshot()
    assert hist == jeng._chosen_k_hist.snapshot()
    assert sum(hist.values()) == eng.stats.spec_rounds > 0
    np.testing.assert_allclose(eng._accept_ema, jeng._accept_ema, rtol=1e-12)
    if label == "accept_all":
        assert set(hist) == {k_max}
        return
    assert min(hist) < k_max and eng._accept_ema[0] < 1.0
    seen = []
    for e in (jeng, eng):
        before = e._chosen_k_hist.snapshot().get(k_max, 0)
        e.submit(PROMPTS[1], 4)
        e.step()        # the admission's varlen round: no speculation
        e.step()        # its EMA was reset at admission: k_max again
        seen.append((e._chosen_k_hist.snapshot().get(k_max, 0) - before,
                     e._accept_ema.tolist()))
    assert seen[1][0] == seen[0][0] == 1
    np.testing.assert_allclose(seen[1][1], seen[0][1], rtol=1e-12)


def test_spec_rollback_under_preemption_matches_jax(weights):
    jeng, eng, want, got = _pair(weights, "accept_all", 3, num_blocks=6)
    _assert_same(jeng, eng, want, got)
    assert eng.stats.preemptions > 0


def test_sampled_spec_matches_jax_and_rescoring(weights):
    """Sampled serving with the one-layer draft model (some drafts kept,
    some corrected): JAX's draws replayed give JAX's tokens, log_beta
    within 1e-5, and log_beta within 1e-5 of the verifier's
    teacher-forced re-scoring (β is the verifier's)."""
    jeng, eng, want, got = _pair(weights, "model", 3, temperature=1.0,
                                 top_p=1.0, seed=5, budgets=[8, 11, 6])
    _assert_same(jeng, eng, want, got)
    assert 0 < eng.stats.accepted_tokens < eng.stats.drafted_tokens
    assert min(float(t.log_beta.min()) for t in got) < -0.1
    for t in got:
        row = np.concatenate([t.prompt, t.tokens])
        logp, _, _ = score_tokens(BUNDLE, weights["port"],
                                  torch.from_numpy(row)[None].long(),
                                  len(t.prompt))
        np.testing.assert_allclose(logp[0].numpy(), t.log_beta, rtol=0,
                                   atol=1e-5)


_SELFSPEC_JAX = {}


def _selfspec_run(eng, store, versions, conv):
    """Two requests; two publishes after the third step evict the
    draft's version from the capacity-2 ring.  Returns the engine's and
    store's (version, draft version, pins) before and after, and the
    trajectories."""
    start = (eng.version, eng.draft.version, store.pinned_versions())
    reqs = [eng.submit(r, n) for r, n in zip(PROMPTS[:2], (12, 9))]
    trajs = []
    for _ in range(3):
        trajs += eng.step()
    store.publish(conv(versions[2]))
    store.publish(conv(versions[3]))
    trajs += eng.run(max_steps=200)
    by_id = {t.request_id: t for t in trajs}
    end = (eng.version, eng.draft.version, store.pinned_versions())
    return start, end, [by_id[r.request_id] for r in reqs]


@pytest.mark.parametrize("private", [False, True])
def test_selfspec_matches_jax(weights, private):
    """Self-speculation over a store of capacity 2: the draft pins
    latest - 1, keeps reading it after its ring slot is overwritten, and
    re-pins after each swap, with the JAX engine's versions, pins,
    tokens and stats on the same inputs (``private``: the threaded
    producer's private-weights mode, which copies instead of holding)."""
    versions = [weights["jax"]]
    for _ in range(3):
        versions.append(jax.tree.map(lambda x: x + 0.01, versions[-1]))
    ekw = dict(ENGINE_KW, temperature=GREEDY, seed=3, speculate_k=2,
               draft=("version", -1))
    if "run" not in _SELFSPEC_JAX:
        jstore = JaxPolicyStore(versions[0], capacity=2)
        jstore.publish(versions[1])
        jeng = JaxServeEngine(JAX_BUNDLE, store=jstore, **ekw)
        _SELFSPEC_JAX["run"] = (_selfspec_run(jeng, jstore, versions,
                                              lambda t: t),
                                jax_collect_serve_stats(jeng))
    (jstart, jend, jtrajs), jst = _SELFSPEC_JAX["run"]
    store = PolicyStore(_port(versions[0]), capacity=2)
    store.publish(_port(versions[1]))
    eng = ServeEngine(BUNDLE, store=store, device="cpu", **ekw)
    _ReplayJaxNoise(eng, 3, GREEDY, 1.0)
    if private:
        eng.use_private_weights()
    start, end, trajs = _selfspec_run(eng, store, versions, _port)
    assert start == jstart
    assert end == jend
    for t, jt in zip(trajs, jtrajs):
        np.testing.assert_array_equal(t.tokens, jt.tokens)
        np.testing.assert_array_equal(t.versions, jt.versions)
        np.testing.assert_allclose(t.log_beta, jt.log_beta, rtol=0,
                                   atol=1e-5)
    st = collect_serve_stats(eng)
    for key in ("drafted_tokens", "accepted_tokens", "spec_rounds", "swaps",
                "draft_version", "draft_version_lag_histogram",
                "tokens_out"):
        assert st[key] == jst[key], key
    # The case exercises what it is for: a swap mid-request, a re-pin.
    assert len({int(v) for t in trajs for v in t.versions}) > 1
    assert st["swaps"] > 0 and st["drafted_tokens"] > 0
    if private:
        # The draft reads its own copy of its version, equal to the
        # store's.
        theirs = store.get(eng.draft.version)
        assert eng.draft.params["embed"]["table"] is not \
            theirs["embed"]["table"]
        torch.testing.assert_close(eng.draft.params, theirs, rtol=0, atol=0)
