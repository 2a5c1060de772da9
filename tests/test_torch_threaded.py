"""Port vs JAX: the threaded regimes on the CPU.

Each test runs one script against ``repro.runtime`` and against
``repro_torch.runtime`` and compares what comes out.  In these regimes
lag comes from timing, so the scripts either fix the timing (a producer
that waits on semaphores the test releases, so every item's snapshot
version and every publish land in a known order) and compare the item
streams exactly, or compare the properties both must hold whatever the
timing (the engine-driven regimes).

* ``ThreadedRegime`` lock-stepped: ``(behavior_version,
  enqueue_learner_version, lag, weight)`` of every item and the queue's
  stats equal, with ``pass_through`` and with ``tv_gate`` (the TV a
  python float of the params, so both sides compute the same number);
* a torn read: ``capacity=1``, the producer reads one leaf, the test
  publishes (overwriting the one ring slot), the producer reads the
  other; both stores hand the producer one version in every leaf;
* ``EngineThreadedRegime`` and the threaded ``ServeRolloutProducer``
  (the reference's ``tests/test_serve_engine.py`` threaded-engine
  script): per-token versions whose minimum is the item's tag, a publish
  made before ``start`` seen by every trajectory, a shared store
  required;
* the bounded queue under two threads: backpressure at ``maxsize``, FIFO
  order through an admission that runs outside the lock while the
  producer puts, ``close`` waking a blocked ``put`` with ``QueueClosed``;
* ``run_async_rl(runtime="threaded")`` and ``train rl|rlvr --runtime
  threaded --device cpu``: they finish, join their thread, and print
  the JAX launcher's JSON keys;
* a producer crash re-raised by ``next_item``; ``supervisor=`` refused
  (the port has no supervision yet, Queue A 6).
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models.registry import build as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.models.registry import build
from repro_torch.serve import ServeEngine
from repro_torch.utils.bridge import from_jax_params
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

WAIT = 30.0          # seconds any one step of a script may take


def _params(pkg, v):
    if pkg is jrt:
        return {"a": jnp.full((3,), float(v)), "b": jnp.full((2,), float(v))}
    return {"a": torch.full((3,), float(v)), "b": torch.full((2,), float(v))}


def _first(x):
    return float(np.asarray(x).reshape(-1)[0])


def _acquire(sem):
    assert sem.acquire(timeout=WAIT), "the producer thread stalled"


# --- ThreadedRegime, lock-stepped -------------------------------------------

# Publishes the test makes while item k is being produced (after the
# producer took its snapshot, before it returns).
DURING = (0, 1, 3, 0, 2, 1)


def _lockstep(pkg, controller):
    store = pkg.PolicyStore(_params(pkg, 0), capacity=4)
    tv_fn = None
    if controller:
        def tv_fn(payload):
            return abs(_first(store.latest()[0]["a"]) - payload) / 10.0
    adm = pkg.make_controller(pkg.parse_controller_spec(
        controller or "pass_through"), tv_fn=tv_fn)
    queue = pkg.TrajectoryQueue(maxsize=2, admission=adm)
    entered, go = threading.Semaphore(0), threading.Semaphore(0)

    def producer(params):
        entered.release()
        _acquire(go)
        return _first(params["a"])

    regime = pkg.make_regime("threaded", store, queue, producer,
                             max_items=len(DURING))
    regime.start()
    items = []
    try:
        for during in DURING:
            _acquire(entered)
            for _ in range(during):
                store.publish(_params(pkg, store.version + 1))
            go.release()
            item = regime.next_item(store.version, timeout=WAIT)
            items.append((item.behavior_version,
                          item.enqueue_learner_version, item.lag,
                          round(item.weight, 12), item.payload))
        assert regime.next_item(store.version, timeout=WAIT) is None
    finally:
        regime.stop()
    assert not regime._thread.is_alive()
    return items, queue.stats().as_dict()


@pytest.mark.parametrize("controller", [
    None, "tv_gate:delta=0.2,mode=downweight"])
def test_lockstepped_threaded_regime_matches_jax(controller):
    want, want_stats = _lockstep(jrt, controller)
    got, got_stats = _lockstep(trt, controller)
    assert got == want
    assert got_stats == want_stats
    # The script does what it claims: lags follow the publishes.
    assert [lag for _, _, lag, _, _ in got] == list(DURING)
    if controller:
        assert got_stats["downweighted"] >= 2
        assert any(w < 1.0 for *_, w, _ in got)


def _torn(pkg):
    store = pkg.PolicyStore(_params(pkg, 0), capacity=1)
    queue = pkg.TrajectoryQueue(maxsize=1)
    read_a, go = threading.Semaphore(0), threading.Semaphore(0)

    def producer(params):
        a = _first(params["a"])
        read_a.release()
        _acquire(go)
        return a, _first(params["b"])

    regime = pkg.make_regime("threaded", store, queue, producer,
                             max_items=1)
    regime.start()
    try:
        _acquire(read_a)
        store.publish(_params(pkg, 1))   # overwrites the one ring slot
        go.release()
        item = regime.next_item(store.version, timeout=WAIT)
    finally:
        regime.stop()
    return item.payload, item.behavior_version, item.lag


def test_threaded_reader_sees_one_version_in_every_leaf():
    want = _torn(jrt)
    assert want == ((0.0, 0.0), 0, 1)
    assert _torn(trt) == want


def test_snapshot_is_private_and_copied_under_the_lock():
    store = trt.PolicyStore(_params(trt, 0), capacity=1)
    snap, version = store.snapshot()
    store.publish(_params(trt, 5))
    assert version == 0 and _first(snap["b"]) == 0.0
    out = {k: torch.empty_like(v) for k, v in snap.items()}
    same, version = store.snapshot(out=out)
    assert same is out and version == 1 and _first(out["a"]) == 5.0
    # A held version is found past the overwrite of its slot.
    held, v = store.hold()
    store.publish(_params(trt, 6))
    assert _first(store.snapshot(v)[0]["a"]) == 5.0
    store.unhold(v)
    assert store.latest_version() == 2


# --- the engine-driven regimes ----------------------------------------------

TOK = get_tokenizer()
SERVE_CFG = dict(name="serve-test", arch_type="dense", n_layers=2,
                 d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab_size=TOK.vocab_size)
JBUNDLE = jax_build(JModelConfig(**SERVE_CFG))
BUNDLE = build(ModelConfig(**SERVE_CFG))
JPARAMS = JBUNDLE.init(jax.random.PRNGKey(0))
PROMPTS = [np.asarray(TOK.encode(p), np.int32)
           for p in ("1+2=?#", "3*4=?#", "10-7=?#")]


def _shift(pkg, params):
    if pkg is jrt:
        return jax.tree.map(lambda x: x + 0.001, params)
    return {k: _shift(pkg, v) if isinstance(v, dict) else v + 0.001
            for k, v in params.items()}


def _engine(pkg, store, **kw):
    kw = {**dict(num_blocks=32, block_size=4, max_batch=2, max_seq_len=64,
                 temperature=1.0, seed=11), **kw}
    if pkg is jrt:
        return JaxServeEngine(JBUNDLE, store=store, **kw)
    return ServeEngine(BUNDLE, store=store, device="cpu", **kw)


def _store(pkg, capacity=4):
    p = JPARAMS if pkg is jrt else from_jax_params(
        jax.tree.map(np.asarray, JPARAMS), "cpu")
    return pkg.PolicyStore(p, capacity=capacity)


def _engine_script(pkg):
    """The reference's threaded-engine script, with the first publish
    made before start (so every trajectory must see it)."""
    store = _store(pkg)
    queue = pkg.TrajectoryQueue(maxsize=4)
    eng = _engine(pkg, store)
    it = iter([(PROMPTS[i % 3], 6) for i in range(4)])
    regime = pkg.make_regime("threaded_engine", store, queue,
                             lambda: next(it, None), engine=eng,
                             max_items=4)
    store.publish(_shift(pkg, store.latest()[0]))
    regime.start()
    consumed = []
    try:
        while (item := regime.next_item(store.version,
                                        timeout=WAIT)) is not None:
            consumed.append(item)
            store.publish(_shift(pkg, store.latest()[0]))
    finally:
        regime.stop()
    assert not regime._thread.is_alive()
    return consumed, eng


@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "torch"])
def test_engine_threaded_regime_tags_per_token_versions(pkg):
    consumed, eng = _engine_script(pkg)
    assert len(consumed) == 4
    for item in consumed:
        versions = item.meta["versions"]
        assert len(versions) == item.payload.num_tokens
        assert item.behavior_version == min(versions)
        assert item.behavior_version_newest == max(versions)
        assert min(versions) >= 1            # the publish before start
        assert item.lag >= 0
    assert eng.stats.swaps >= 1
    if pkg is trt:
        # A thread other than the publisher's generates from a private
        # copy, never from the ring.
        assert eng._private
        ring = {t.untyped_storage().data_ptr()
                for t in tree_leaves(eng.store.buffer.stacked)}
        assert not {t.untyped_storage().data_ptr()
                    for t in tree_leaves(eng.params)} & ring


@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "torch"])
def test_engine_threaded_regime_requires_shared_store(pkg):
    store, other = _store(pkg, 2), _store(pkg, 2)
    eng = _engine(pkg, other)
    with pytest.raises(ValueError, match="share"):
        pkg.make_regime("threaded_engine", store, pkg.TrajectoryQueue(),
                        lambda: None, engine=eng)
    dataset = (JaxMathTaskDataset if pkg is jrt else MathTaskDataset)(
        prompt_len=12, level=0, pool_size=64, seed=0)
    with pytest.raises(ValueError, match="share"):
        pkg.ServeRolloutProducer(store, pkg.TrajectoryQueue(), eng, dataset,
                                 prompts_per_minibatch=1,
                                 completions_per_prompt=1, max_new_tokens=1,
                                 threaded=True)


def _serve_producer_script(pkg, version_offset):
    store = _store(pkg)
    queue = pkg.TrajectoryQueue(maxsize=2)
    eng = _engine(pkg, store, max_batch=4)
    dataset = (JaxMathTaskDataset if pkg is jrt else MathTaskDataset)(
        prompt_len=12, level=0, pool_size=64, seed=0)
    prod = pkg.ServeRolloutProducer(
        store, queue, eng, dataset, prompts_per_minibatch=2,
        completions_per_prompt=2, max_new_tokens=5, threaded=True,
        max_items=3, version_offset=version_offset)
    store.publish(_shift(pkg, store.latest()[0]))
    prod.start()
    items = []
    try:
        while (item := prod.next_item(store.version,
                                      timeout=WAIT)) is not None:
            items.append(item)
            store.publish(_shift(pkg, store.latest()[0]))
    finally:
        prod.stop()
    assert not prod._thread.is_alive()
    return items


@pytest.mark.parametrize("version_offset", [None, 1])
@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "torch"])
def test_threaded_serve_producer_tags_minibatch_versions(pkg,
                                                         version_offset):
    items = _serve_producer_script(pkg, version_offset)
    assert len(items) == 3
    for item in items:
        versions = np.asarray(item.payload.versions)
        assert versions.shape == (4, 5)
        assert item.behavior_version == int(versions.min())
        assert item.behavior_version_newest == int(versions.max())
        assert item.meta["producer"] == "serve"
        assert item.lag >= 0
        if version_offset is None:
            assert versions.min() >= 1       # the publish before start
        else:
            # Forced lag: one version a minibatch, k back at its start.
            assert versions.min() == versions.max()
    tokens = items[0].payload.gen.tokens
    assert tuple(tokens.shape) == (4, 12 + 5)


# --- the queue under two threads ---------------------------------------------


def _queue_script(pkg):
    seen_depth = []

    class SlowAdmission(pkg.PassThrough):
        def admit(self, item):
            seen_depth.append(queue.qsize())
            time.sleep(0.002)            # the producer puts meanwhile
            return super().admit(item)

    queue = pkg.TrajectoryQueue(maxsize=2, admission=SlowAdmission())
    errors = []

    def produce():
        try:
            for i in range(40):
                queue.put(i, behavior_version=0, learner_version=0)
        except pkg.QueueClosed:
            errors.append("closed")

    t = threading.Thread(target=produce)
    t.start()
    got = [queue.get(learner_version=0, timeout=WAIT).payload
           for _ in range(10)]
    time.sleep(0.05)                     # the producer blocks on a full queue
    depth = queue.qsize()
    queue.close()
    t.join(WAIT)
    rest = []
    while (item := queue.get(learner_version=0, timeout=0.1)) is not None:
        rest.append(item.payload)
    return got, depth, errors, rest, max(seen_depth), queue.stats()


@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "torch"])
def test_bounded_queue_under_two_threads(pkg):
    got, depth, errors, rest, max_seen, stats = _queue_script(pkg)
    assert got == list(range(10))
    assert depth == 2 and max_seen <= 2      # backpressure at maxsize
    assert errors == ["closed"]              # close woke the blocked put
    assert rest == [10, 11]                  # drained in order, then None
    assert stats.puts == 12 and stats.admitted == 12


# --- runners and launchers ---------------------------------------------------


def _producer_threads():
    return [t for t in threading.enumerate()
            if t.name in ("runtime-producer", "engine-producer",
                          "serve-producer") and t.is_alive()]


def test_run_async_rl_threaded_finishes_and_joins():
    from repro_torch.train import (AsyncRLRunConfig, RLHyperparams,
                                   run_async_rl)

    res = run_async_rl(AsyncRLRunConfig(
        runtime="threaded", n_actors=4, rollout_steps=8, total_phases=3,
        eval_episodes=2, buffer_capacity=1, device="cpu",
        hp=RLHyperparams(num_epochs=1, num_minibatches=2)))
    assert len(res.returns) == 3 and np.isfinite(res.returns).all()
    queue = res.runtime_stats["queue"]
    assert queue["admitted"] == 3 and queue["puts"] <= 12
    assert sum(queue["lag_histogram"].values()) == 3
    assert res.runtime_stats["policy_version"] == 3
    assert not _producer_threads()


@pytest.mark.parametrize("argv", [
    ["rl", "--n-actors", "4", "--rollout-steps", "8", "--phases", "2",
     "--buffer-capacity", "1"],
    ["rlvr", "--warmup-steps", "1", "--n-minibatches", "2", "--phases",
     "1"],
    ["rlvr", "--warmup-steps", "1", "--n-minibatches", "2", "--phases",
     "1", "--producer", "serve", "--controller",
     "tv_gate:delta=0.05,mode=downweight"],
], ids=["rl", "rlvr", "rlvr-serve"])
def test_launcher_runs_threaded_on_the_cpu(argv, capsys):
    from repro_torch.launch import train

    assert train.main(argv + ["--runtime", "threaded", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    # The keys repro.launch.train prints for each mode.
    if argv[0] == "rl":
        assert set(report) == {"runtime", "returns", "final_tv",
                               "runtime_stats"}
        assert len(report["returns"]) == 2
    else:
        assert set(report) == {"arch", "algorithm", "runtime",
                               "n_minibatches", "eval_accuracy", "final_tv",
                               "runtime_stats", "train_step_ms"}
        assert report["train_step_ms"]["count"] == 2
    assert report["runtime"] == "threaded"
    assert not _producer_threads()


# --- crashes and refusals ----------------------------------------------------


@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "torch"])
def test_producer_crash_is_reraised_by_next_item(pkg):
    store = pkg.PolicyStore(_params(pkg, 0), capacity=2)
    queue = pkg.TrajectoryQueue(maxsize=2)
    calls = []

    def producer(params):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("boom")
        return 1.0

    regime = pkg.make_regime("threaded", store, queue, producer)
    regime.start()
    try:
        assert regime.next_item(0, timeout=WAIT).payload == 1.0
        with pytest.raises(RuntimeError, match="crashed") as info:
            regime.next_item(0, timeout=WAIT)
        assert isinstance(info.value.__cause__, ValueError)
        assert queue.closed
    finally:
        regime.stop()


def test_supervisor_is_refused_naming_its_queue_item():
    store = trt.PolicyStore(_params(trt, 0), capacity=2)
    queue = trt.TrajectoryQueue()
    with pytest.raises(NotImplementedError, match="A 6"):
        trt.make_regime("threaded", store, queue, lambda p: 0,
                        supervisor=object())
    eng_store = _store(trt)
    eng = _engine(trt, eng_store)
    with pytest.raises(NotImplementedError, match="A 6"):
        trt.make_regime("threaded_engine", eng_store, queue, lambda: None,
                        engine=eng, supervisor=object())
    with pytest.raises(NotImplementedError, match="A 6"):
        trt.ServeRolloutProducer(
            eng_store, queue, eng, MathTaskDataset(prompt_len=12,
                                                   pool_size=64),
            prompts_per_minibatch=1, completions_per_prompt=1,
            max_new_tokens=1, threaded=True, supervisor=object())
    assert "threaded" in trt.REGIMES and "threaded_engine" in trt.REGIMES
    assert trt.ThreadedRegime is not None and trt.EngineThreadedRegime
