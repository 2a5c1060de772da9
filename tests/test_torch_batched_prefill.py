"""Port vs JAX: the serve engine's batched prefill (``chunked_prefill=
False``, with ``batch_prefill`` on and off), the deprecated path the
JAX engine keeps for comparison.

On the same weights and prompts the port's engine is held to the JAX
engine: greedy tokens exact, sampled tokens exact on JAX's replayed
noise (``_ReplayJaxNoise``) with ``log_beta`` within 1e-5, the same
``prefills`` / ``prefill_dispatches`` / ``prefill_tokens`` and round
counts, the same tracer events, and the paged pools within 2e-5 of
their largest magnitude (float32 sums in another order, through weights
scaled x3 where the served tokens must vary).  Greedy serving's
``log_beta`` is not compared: at the engine's floor temperature of 1e-6
it is float32 noise of logits scaled by 1e6 in both packages.  Covered:
reduced qwen2.5-0.5b (with a preemption), a 2-layer config at head dim
128 (qwen2.5-14b's group of 5), the prefix cache (best-of-4 siblings in
one suffix dispatch after a mid-page copy-on-write) with a model draft's
pool, the ``DeprecationWarning``, and the launcher's
``--no-chunked-prefill [--no-batch-prefill]``."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models.registry import build as jax_build
from repro.obs.tracer import Tracer as JaxTracer
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import build
from repro_torch.obs.tracer import Tracer
from repro_torch.serve import ServeEngine
from repro_torch.utils.bridge import from_jax_params
from test_torch_serve import (BUDGETS, CFG, ENGINE_KW, JCFG, PROMPTS, TOK,
                              _ReplayJaxNoise, weights)  # noqa: F401

torch.set_num_threads(1)

POOL_TOL = 2e-5
# A 2-layer config at head dim 128 with qwen2.5-14b's group of 5.
JCFG128 = jax_reduced_config("qwen2.5-14b", vocab=TOK.vocab_size).replace(
    d_head=128)
CFG128 = reduced_config("qwen2.5-14b", vocab=TOK.vocab_size).replace(
    d_head=128)
# The prefix-cache run: the prefix cache test's small model and a
# one-layer model draft of the same vocab.
SMALL_KW = dict(name="batched-test", arch_type="dense", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab_size=TOK.vocab_size)
DRAFT_KW = dict(SMALL_KW, name="batched-draft", n_layers=1)


# The serve test's prompts, the two of 6 ids first: they share a padded
# length (8) and are admitted together.
ORDER = (2, 3, 0, 1)


def _serve(eng):
    for i in ORDER:
        eng.submit(np.asarray(TOK.encode(PROMPTS[i]), np.int32), BUDGETS[i],
                   request_id=i)
    return {t.request_id: t for t in eng.run(max_steps=300)}


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


def _jax_engine(*args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return JaxServeEngine(*args, **kw)


def _engine(*args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ServeEngine(*args, device="cpu", **kw)


def _strip(tracer):
    return [(e.ph, e.name, e.pid, e.tid, e.id, e.args)
            for e in tracer.events()]


def _assert_pools_close(got, want):
    for key in ("k_pages", "v_pages"):
        g, w = got[key].numpy(), np.asarray(want[key])
        err = np.abs(g - w).max()
        assert err <= POOL_TOL * max(1.0, np.abs(w).max()), (key, err)


def _assert_same_serving(eng, jeng, got, want, sampled):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        if sampled:
            np.testing.assert_allclose(got[rid].log_beta, want[rid].log_beta,
                                       rtol=0, atol=1e-5)
        assert got[rid].finish_reason == want[rid].finish_reason
        assert got[rid].num_preemptions == want[rid].num_preemptions
    for key in ("steps", "decode_steps", "prefills", "prefill_dispatches",
                "prefill_tokens", "tokens_out", "occupancy_sum",
                "preemptions", "cow_copies", "spec_rounds", "drafted_tokens",
                "accepted_tokens"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    _assert_pools_close(eng.pages, jeng.pages)
    assert eng.allocator.num_free == jeng.allocator.num_free


@pytest.mark.parametrize("batch_prefill", [True, False])
@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.8, 0.9)])
def test_batched_prefill_matches_jax(weights, temperature, top_p,  # noqa: F811
                                     batch_prefill):
    """Reduced qwen2.5-0.5b, the serve test's prompts and small pool (a
    preemption re-prefills over prompt + emitted tokens)."""
    jparams, params = weights
    kw = dict(ENGINE_KW, temperature=temperature, top_p=top_p, seed=3,
              chunked_prefill=False, batch_prefill=batch_prefill)
    jtracer, tracer = JaxTracer(detail="full"), Tracer(detail="full")
    jeng = _jax_engine(jax_build(JCFG), jparams, tracer=jtracer, **kw)
    want = _serve(jeng)
    eng = _engine(build(CFG), params, tracer=tracer, **kw)
    if temperature > 0:
        _ReplayJaxNoise(eng, 3, temperature, top_p)
    got = _serve(eng)
    _assert_same_serving(eng, jeng, got, want, temperature > 0)
    assert eng.stats.preemptions >= 1
    assert _strip(tracer) == _strip(jtracer)
    spans = [e.args["n"] for e in tracer.events()
             if e.name == "prefill" and e.ph == "B"]
    assert len(spans) == eng.stats.prefill_dispatches
    if batch_prefill:
        assert max(spans) > 1                # one dispatch, several prompts
    else:
        assert set(spans) == {1}
    if temperature == 0:
        assert len({int(t) for r in got.values() for t in r.tokens}) > 5


@pytest.fixture(scope="module")
def weights128():
    jp = jax_build(JCFG128).init(jax.random.PRNGKey(0))
    return jp, _port(jp)


@pytest.mark.parametrize("temperature,batch_prefill",
                         [(0.0, True), (0.8, False)])
def test_batched_prefill_at_head_dim_128_matches_jax(weights128, temperature,
                                                     batch_prefill):
    """The same serving at head dim 128, 5 query heads a kv head."""
    jparams, params = weights128
    kw = dict(ENGINE_KW, temperature=temperature, seed=5,
              chunked_prefill=False, batch_prefill=batch_prefill)
    jeng = _jax_engine(jax_build(JCFG128), jparams, **kw)
    want = _serve(jeng)
    eng = _engine(build(CFG128), params, **kw)
    if temperature > 0:
        _ReplayJaxNoise(eng, 5, temperature, 1.0)
    got = _serve(eng)
    assert eng.pages["k_pages"].shape[-1] == 128
    _assert_same_serving(eng, jeng, got, want, temperature > 0)


def test_batched_prefill_with_prefix_cache_and_model_draft_matches_jax():
    """Best-of-4 over two prompts of 9 ids (pages of 4): the first
    prompt's first copy prefills dense, each prompt's three siblings
    share one suffix dispatch after a copy-on-write of the mid-page
    match; a
    one-layer model draft (``speculate_k=2``) gets the same rows in its
    own pool.  Tokens, counts, the verifier's and the draft's pools
    against JAX."""
    jp = jax_build(JaxModelConfig(**SMALL_KW)).init(jax.random.PRNGKey(0))
    jd = jax_build(JaxModelConfig(**DRAFT_KW)).init(jax.random.PRNGKey(1))
    kw = dict(num_blocks=64, block_size=4, max_batch=4, max_seq_len=64,
              temperature=1e-4, seed=0, prefix_cache=True, speculate_k=2,
              chunked_prefill=False)
    prompts = [np.asarray(TOK.encode(p), np.int32)
               for p in ("12+345=?#", "998-76=?#")]
    jtracer, tracer = JaxTracer(detail="spans"), Tracer(detail="spans")
    jeng = _jax_engine(jax_build(JaxModelConfig(**SMALL_KW)), jp,
                       draft=("model", jax_build(JaxModelConfig(**DRAFT_KW)),
                              jd), tracer=jtracer, **kw)
    eng = _engine(build(ModelConfig(**SMALL_KW)), _port(jp),
                  draft=("model", build(ModelConfig(**DRAFT_KW)), _port(jd)),
                  tracer=tracer, **kw)
    _ReplayJaxNoise(eng, 0, 1e-4, 1.0)
    out = []
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            for j in range(4):
                e.submit(p, 8, request_id=f"p{i}c{j}")
        out.append({t.request_id: t for t in e.run(max_steps=600)})
    want, got = out
    _assert_same_serving(eng, jeng, got, want, False)
    _assert_pools_close(eng.draft.pages, jeng.draft.pages)
    # Both prompts start with BOS: the second's first copy matches that
    # one row (a copy-on-write of a 1-row match, a suffix of its own).
    assert eng.scheduler.prefix_hits == jeng.scheduler.prefix_hits == 7
    assert eng.stats.cow_copies == 7
    assert eng.stats.drafted_tokens > 0
    assert _strip(tracer) == _strip(jtracer)
    suffix = [e.args["n"] for e in tracer.events()
              if e.name == "suffix_prefill" and e.ph == "B"]
    assert suffix == [3, 1, 3]
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_batched_prefill_warns_it_is_deprecated(weights):  # noqa: F811
    with pytest.warns(DeprecationWarning, match="deprecated"):
        ServeEngine(build(CFG), weights[1], device="cpu",
                    chunked_prefill=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        ServeEngine(build(CFG), weights[1], device="cpu")


def _launch(module, argv, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert module.main(argv) in (0, None)
    return capsys.readouterr().out


def _lines(out, head):
    return [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith(head)]


def test_launcher_batched_prefill_on_the_cpu(capsys):
    """``serve --engine continuous --no-chunked-prefill``, greedy: five
    prompts share dispatches by padded length (the JAX launcher's counts
    for these flags: 16 tokens, 5 prefills in 2 dispatches); with
    ``--no-batch-prefill`` each takes its own, and the text is the same,
    as it is with chunked prefill."""
    from repro_torch.launch import serve

    argv = ["--engine", "continuous", "--requests", "5", "--mixed-lengths",
            "2,5", "--temperature", "0", "--device", "cpu"]
    outs = [_launch(serve, argv + flags, capsys)
            for flags in ([], ["--no-chunked-prefill"],
                          ["--no-chunked-prefill", "--no-batch-prefill"])]
    for out in outs:
        head = _lines(out, "continuous decode:")[0].split(" in ")[0]
        assert head == "continuous decode: 16 tokens / 5 requests"
    assert "prefills 5 (2 dispatches)" in _lines(outs[1], "occupancy")[0]
    assert "prefills 5 (5 dispatches)" in _lines(outs[2], "occupancy")[0]

    def texts(out):                      # request ids count on
        return [ln.split("->")[1].split("(")[0] for ln in _lines(out, "[")]

    assert texts(outs[0]) == texts(outs[1]) == texts(outs[2])


@pytest.mark.parametrize("argv", [
    ["--engine", "static", "--batch", "2", "--max-new-tokens", "3"],
    ["--engine", "continuous", "--requests", "2", "--max-new-tokens", "3"],
    ["--engine", "continuous", "--requests", "2", "--max-new-tokens", "3",
     "--no-chunked-prefill"],
])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "codeqwen1.5-7b"])
def test_launcher_serves_the_new_archs_on_the_cpu(arch, argv, capsys):
    """The two new configs, reduced, through both engines."""
    from repro_torch.launch import serve

    out = _launch(serve, ["--arch", arch, "--device", "cpu",
                          "--temperature", "0", *argv], capsys)
    if argv[1] == "static":
        assert _lines(out, "decode: 6 tokens in")
    else:                                # a request may emit EOS early
        (line,) = _lines(out, "continuous decode:")
        assert " tokens / 2 requests in " in line
