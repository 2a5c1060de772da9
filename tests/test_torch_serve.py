"""Port vs JAX: the continuous-batching ``ServeEngine`` on the same
weights at ``reduced_config("qwen2.5-0.5b")``.

Greedy serving (temperature -> 0) is token-exact, with a prompt longer
than ``prefill_chunk``, ``decode_chunk=4`` and a pool small enough to
force a preemption.  Sampled serving replays the JAX engine's own
Gumbel noise into the port (the JAX PRNG stream cannot be drawn in
torch) and is token-exact too; ``log_beta`` agrees within 1e-5 in both.
The copied scheduler makes the reference scheduler's decisions."""
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
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.paged_cache import make_allocator as jax_make_allocator
from repro.serve.scheduler import (ContinuousBatchingScheduler as
                                   JaxScheduler, Request as JaxRequest)
from repro_torch.configs import reduced_config
from repro_torch.metrics import collect_serve_stats
from repro_torch.models.registry import build
from repro_torch.obs.tracer import Tracer
from repro_torch.rollout.sampler import sample
from repro_torch.serve import ServeEngine
from repro_torch.serve.paged_cache import make_allocator
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
CFG = reduced_config("qwen2.5-0.5b", vocab=TOK.vocab_size)
# The second prompt (19 ids) is longer than prefill_chunk; 9 pages of 4
# rows for 3 slots force a preemption.
PROMPTS = ["12+345=?#", "998-76=?#" * 2, "7*8=?#", "1+1=?#"]
BUDGETS = [9, 6, 12, 5]
ENGINE_KW = dict(num_blocks=9, block_size=4, max_batch=3, max_seq_len=64,
                 decode_chunk=4, prefill_chunk=8, dispatch_budget=12)


@pytest.fixture(scope="module")
def weights():
    """Reference init with dense weights scaled x3, so random-init greedy
    output varies from token to token instead of repeating one id."""
    params = jax_build(JCFG).init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 3.0 if "'w'" in jax.tree_util.keystr(p) else a,
        params)
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def _serve(eng):
    for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS)):
        eng.submit(np.asarray(TOK.encode(p), np.int32), b, request_id=i)
    return {t.request_id: t for t in eng.run(max_steps=300)}


class _ReplayJaxNoise:
    """Feeds the port's sampler the Gumbel noise the JAX engine draws:
    one key per dispatch off the engine's PRNG chain; a decode chunk
    splits its key per step, a varlen round uses it whole."""

    def __init__(self, eng, seed, temperature, top_p):
        self.key = jax.random.PRNGKey(seed)
        self.keys = []
        varlen, decode = eng._varlen, eng._decode

        def _dispatch(n):
            self.key, k = jax.random.split(self.key)
            self.keys = [k] if n is None else list(jax.random.split(k, n))

        def _varlen(*a):
            _dispatch(None)
            return varlen(*a)

        def _decode(*a):
            _dispatch(eng.decode_chunk)
            return decode(*a)

        def _sample(logits):
            g = jax.random.gumbel(self.keys.pop(0), tuple(logits.shape))
            return sample(logits, temperature, top_p,
                          torch.from_numpy(np.array(g)))

        eng._varlen, eng._decode, eng._sample = _varlen, _decode, _sample


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (0.8, 0.9)])
def test_serve_engine_matches_jax(weights, temperature, top_p):
    jparams, params = weights
    kw = dict(ENGINE_KW, temperature=temperature, top_p=top_p, seed=3)
    jax_tracer, tracer = JaxTracer(detail="full"), Tracer(detail="full")
    jax_eng = JaxServeEngine(jax_build(JCFG), jparams, tracer=jax_tracer,
                             **kw)
    want = _serve(jax_eng)
    eng = ServeEngine(build(CFG), params, device="cpu", tracer=tracer, **kw)
    if temperature > 0:
        _ReplayJaxNoise(eng, 3, temperature, top_p)
    got = _serve(eng)
    assert sorted(got) == sorted(want) == list(range(len(PROMPTS)))
    assert eng.stats.preemptions == jax_eng.stats.preemptions >= 1
    assert max(len(p) for p in PROMPTS) + 1 > ENGINE_KW["prefill_chunk"]
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        np.testing.assert_allclose(got[rid].log_beta, want[rid].log_beta,
                                   rtol=0, atol=1e-5)
        assert got[rid].finish_reason == want[rid].finish_reason
        assert got[rid].num_preemptions == want[rid].num_preemptions
    if temperature == 0:
        # Greedy output must vary, or token equality says little.
        assert len({int(t) for r in got.values() for t in r.tokens}) > 5
    else:
        assert min(float(r.log_beta.min()) for r in got.values()) < -0.1
    # Round layouts match row for row: same rounds, same counts.
    for key in ("steps", "decode_steps", "prefills", "prefill_dispatches",
                "prefill_tokens", "tokens_out", "occupancy_sum"):
        assert getattr(eng.stats, key) == getattr(jax_eng.stats, key), key
    # collect_serve_stats reads the port's engine unchanged.
    assert set(collect_serve_stats(eng)) == \
        set(jax_collect_serve_stats(jax_eng))
    # The tracer hooks fire the same events with the same arguments:
    # scheduler lifecycle, dispatch spans, counters, per-token instants.
    def strip(tr):
        return [(e.ph, e.name, e.pid, e.tid, e.id, e.args)
                for e in tr.events()]

    assert strip(tracer) == strip(jax_tracer)


def test_deadlines_retire_as_timeouts_like_jax(weights):
    kw = dict(ENGINE_KW, temperature=0.0, request_deadline_s=0.0)
    want = _serve(JaxServeEngine(jax_build(JCFG), weights[0], **kw))
    eng = ServeEngine(build(CFG), weights[1], device="cpu", **kw)
    got = _serve(eng)
    assert sorted(got) == sorted(want)
    for rid, t in got.items():
        assert t.finish_reason == want[rid].finish_reason == "timeout"
        assert t.num_tokens == want[rid].num_tokens
    assert eng.stats.timeouts == len(PROMPTS)


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--engine", "continuous", "--device", "cpu",
                       "--requests", "3", "--mixed-lengths", "2,5",
                       "--temperature", "0"]) == 0
    out = capsys.readouterr().out
    assert "continuous decode: 9 tokens / 3 requests" in out


def _drive(sched_cls, alloc_fn, req_cls):
    """Fixed submit/schedule/retire script; returns every decision."""
    alloc = alloc_fn(5, 4)
    sched = sched_cls(alloc, max_batch=3, max_blocks_per_request=8)
    reqs = [req_cls(prompt=np.arange(n, dtype=np.int32), max_new_tokens=m,
                    request_id=i)
            for i, (n, m) in enumerate([(5, 9), (6, 8), (3, 10), (7, 4),
                                        (2, 2)])]
    for r in reqs:
        sched.submit(r)
    log = []
    for _ in range(30):
        admitted, preempted = sched.schedule(lookahead=2)
        for r in sched.running:           # pretend every running row emits
            r.tokens.append(1)
            r.prefill_done = True
        done = [r for r in sched.running
                if len(r.tokens) >= r.max_new_tokens]
        for r in done:
            sched.retire(r, "length")
        log.append(([r.request_id for r in admitted],
                    [r.request_id for r in preempted],
                    [(r.request_id, r.slot, list(r.blocks))
                     for r in sched.running],
                    [r.request_id for r in done], alloc.num_free))
    return log


def test_scheduler_copy_makes_reference_decisions():
    want = _drive(JaxScheduler, jax_make_allocator, JaxRequest)
    got = _drive(ContinuousBatchingScheduler, make_allocator, Request)
    assert got == want
    assert any(p for _, p, _, _, _ in want)   # the script preempts
    assert not any(r for _, _, r, _, _ in want[-1:])   # and drains


@pytest.mark.parametrize("option", [
    dict(speculate_k=2), dict(prefix_cache=True), dict(mesh=object()),
    dict(chunked_prefill=False)])
def test_unported_options_raise(weights, option):
    with pytest.raises(NotImplementedError):
        ServeEngine(build(CFG), weights[1], device="cpu", **option)
