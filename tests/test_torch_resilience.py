"""Port vs JAX: fault injection, supervision, signal flushing and
checkpoints (``repro_torch.resilience``, ``repro_torch.checkpoint``)
against ``repro.resilience`` and ``repro.checkpoint``.

* the fault-plan grammar and its errors; one ``(plan, seed)`` fires the
  same events at the same calls with the same jittered stalls; poison
  NaNs the leaf JAX's flatten order puts first;
* backoff schedules bit-equal; ``supervise`` restarts, budget and clean
  exits; ``Heartbeat``; one-shot flush handlers;
* the threaded regime under a crash, lock-stepped (the producer waits
  on semaphores the test releases): the restarted producer's first item
  carries the same restart provenance and outage lag spike on both;
  budget exhaustion surfaces as the crash;
* an engine stall past the request deadline (a clock the stall
  advances, so the timing is exact): the same ``timeout`` retirements
  and every page freed, on both engines;
* the trainer under ``nan_publish`` and ``learner_nan``: the poisoned
  publish quarantined and never served, the poisoned step restored from
  memory or from ``guard_checkpoint_dir``, counters, phase logs and
  params against the JAX trainer (params 1e-5: 2-layer d 64 model);
* the threaded serve producer under the chaos bench's plan (port only,
  as ``chip_smoke.py`` phase 25 runs it on the card): it completes, no
  page, refcount or thread leaks, the quarantined version never served;
* checkpoints: files byte-equal, and each package loads the other's,
  bit-equal leaves, for params and for a guard checkpoint's
  ``opt_state``.
"""
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.resilience as jres
import repro.runtime as jrt
import repro_torch.resilience as tres
import repro_torch.runtime as trt
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.mathgen import MathTaskDataset as JaxMathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.models.registry import build as jax_build
from repro.obs.registry import MetricsRegistry as JRegistry
from repro.optim import adamw_init as jax_adamw_init
from repro.serve import ServeEngine as JaxServeEngine
from repro.train.trainer_rlvr import RLVRHyperparams as JHyperparams
from repro.train.trainer_rlvr import RLVRTrainer as JaxRLVRTrainer
from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import ModelConfig
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.models.registry import build
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.optim import adamw_init
from repro_torch.serve import ServeEngine
from repro_torch.train import RLVRHyperparams, RLVRTrainer
from repro_torch.utils.bridge import from_jax_params, to_numpy
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

torch.set_num_threads(1)

WAIT = 30.0
TOK = get_tokenizer()
SMALL = dict(name="resilience-test", arch_type="dense", n_layers=2,
             d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=TOK.vocab_size)
JBUNDLE = jax_build(JModelConfig(**SMALL))
BUNDLE = build(ModelConfig(**SMALL))
JPARAMS = JBUNDLE.init(jax.random.PRNGKey(0))


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


# --- the fault plan ---------------------------------------------------------


@pytest.mark.parametrize("plan", [
    "producer_crash:at_step=2;stall:slot=0,ms=200,count=3;"
    "nan_publish:at_publish=3,p=0.5",
    ["stall:ms=1", "stall:ms=2;stall:ms=3"], "", None,
    "queue_stall:at_call=5,ms=120,site=queue_get,jitter=0.5",
    "learner_nan:at_step=7;nan_publish:version=4,count=2"])
def test_parse_fault_plan_matches_jax(plan):
    want, got = jres.parse_fault_plan(plan), tres.parse_fault_plan(plan)
    assert [(e.kind, e.params, e.count, e.p, e.canonical()) for e in got] \
        == [(e.kind, e.params, e.count, e.p, e.canonical()) for e in want]


@pytest.mark.parametrize("plan", [
    "meteor_strike:at_step=1", "producer_crash:at_publish=1", "stall:ms",
    "stall:=3", "learner_nan:slot=0"])
def test_fault_plan_errors_match_jax(plan):
    with pytest.raises(ValueError) as want:
        jres.parse_fault_plan(plan)
    with pytest.raises(ValueError) as got:
        tres.parse_fault_plan(plan)
    assert str(got.value) == str(want.value)


def _fire(pkg, plan, seed):
    """One script of hook calls; returns every call's outcome, the sleeps
    asked for, and the fired log."""
    sleeps, out = [], []
    reg = (JRegistry if pkg is jres else MetricsRegistry)()
    inj = pkg.FaultInjector(plan, seed=seed, sleep=sleeps.append,
                            registry=reg)
    for step in range(12):
        out.append(inj.stall("engine_step", at_step=step))
        for slot in range(3):
            out.append(inj.stall("engine_step", at_step=step, slot=slot))
        out.append(inj.stall("queue_put", at_call=step))
        out.append(inj.stall("queue_get", at_call=step))
        try:
            inj.crash_if("producer", at_step=step, producer="serve")
            out.append("ok")
        except pkg.InjectedFault as e:
            out.append((str(e), e.site, e.event.canonical()))
    return out, sleeps, inj.fired, inj.fired_counts(), \
        reg.counter_values("fault_injected_total")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("plan", [
    "producer_crash:at_step=2;stall:at_step=4,ms=75;"
    "queue_stall:at_call=5,ms=120",
    "stall:ms=10,p=0.3,count=20,jitter=0.4;"
    "queue_stall:ms=5,p=0.6,count=9,jitter=0.25,site=queue_get;"
    "producer_crash:p=0.2,count=3;stall:slot=1,ms=3,count=4"])
def test_fault_firing_and_jittered_stalls_match_jax(plan, seed):
    want, got = _fire(jres, plan, seed), _fire(tres, plan, seed)
    assert got == want
    assert len(got[2]) > 1 and got[1]         # faults fired, stalls slept


def test_injector_matching_missing_keys_and_exhaustion():
    inj = tres.FaultInjector("stall:slot=3,ms=50", sleep=lambda s: None)
    assert inj.stall("engine_step", at_step=3) == 0.0     # no wildcard
    assert inj.stall("engine_step", slot=3) == 0.05
    assert inj.stall("engine_step", slot=3) == 0.0        # count=1 spent
    assert inj.active and not tres.NULL_INJECTOR.active
    assert tres.NULL_INJECTOR.poison("publish", {"a": 1})[1] is False


def _nan_paths(pkg, params):
    if pkg is jres:
        return [jax.tree_util.keystr(p) for p, x in
                jax.tree_util.tree_flatten_with_path(params)[0]
                if not bool(jnp.all(jnp.isfinite(x)))]
    return [p for p, x in tree_leaves_with_path(params)
            if not bool(torch.isfinite(x).all())]


@pytest.mark.parametrize("which", ["unsorted", "model"])
def test_poison_hits_the_leaf_jax_poisons(which):
    if which == "unsorted":      # insertion order is not JAX's order
        jparams = {"z": jnp.ones((2,)), "b": {"y": jnp.ones((3,)),
                                              "a": jnp.ones((1,))}}
        params = {"z": torch.ones(2), "b": {"y": torch.ones(3),
                                            "a": torch.ones(1)}}
    else:
        jparams = JPARAMS
        params = _port(jparams)
    want, wp = jres.FaultInjector("learner_nan:at_step=7").poison(
        "learner_step", jparams, at_step=7)
    kept = [x.clone() for x in tree_leaves(params)]
    got, gp = tres.FaultInjector("learner_nan:at_step=7").poison(
        "learner_step", params, at_step=7)
    assert wp and gp
    assert _nan_paths(tres, got) == _nan_paths(jres, want)
    assert len(_nan_paths(tres, got)) == 1
    if which == "unsorted":
        assert _nan_paths(tres, got) == ["['b']['a']"]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), kept))
    assert not tres.tree_all_finite(got) and tres.tree_all_finite(params)
    out, poisoned = tres.FaultInjector("learner_nan:at_step=7").poison(
        "learner_step", params, at_step=1)
    assert not poisoned and out is params


# --- backoff, supervise, heartbeat, signals ---------------------------------


@pytest.mark.parametrize("fields", [
    dict(base_ms=50, factor=2.0, max_ms=130, jitter=0.25, max_restarts=4,
         seed=7),
    dict(base_ms=40.0, max_restarts=3, seed=0),
    dict(base_ms=1, max_ms=2, jitter=0.0, max_restarts=2, seed=5)])
def test_backoff_schedules_match_jax(fields):
    want = jres.BackoffPolicy(**fields)
    got = tres.BackoffPolicy(**fields)
    assert got.schedule() == want.schedule()
    assert [got.delay_s(i) for i in range(6)] == [
        want.delay_s(i) for i in range(6)]
    with pytest.raises(ValueError):
        got.delay_s(-1)


def _supervised(pkg, fail_until, max_restarts, clean=False):
    class Done(Exception):
        pass

    reg = (JRegistry if pkg is jres else MetricsRegistry)()
    attempts = []

    def run(ctx):
        attempts.append((ctx.attempt, type(ctx.last_error).__name__))
        if clean:
            raise Done()
        if ctx.attempt < fail_until:
            raise RuntimeError(f"boom {ctx.attempt}")

    policy = pkg.BackoffPolicy(base_ms=1, max_ms=2, max_restarts=max_restarts,
                               seed=0)
    try:
        result = pkg.supervise(run, policy=policy, name="p0", registry=reg,
                               clean_exits=(Done,))
    except pkg.SupervisionError as e:
        result = ("exhausted", e.restarts, type(e.last_error).__name__)
    return result, attempts, reg.counter_values("watchdog_restart_total")


@pytest.mark.parametrize("case", [(2, 3, False), (5, 2, False),
                                  (5, 3, True)],
                         ids=["restarts", "budget", "clean_exit"])
def test_supervise_matches_jax(case):
    want, got = _supervised(jres, *case), _supervised(tres, *case)
    assert got == want


def test_supervise_stops_during_backoff():
    stop = threading.Event()
    calls = []

    def run(ctx):
        calls.append(ctx.attempt)
        stop.set()
        raise RuntimeError("crash")

    t0 = time.monotonic()
    restarts = tres.supervise(run, policy=tres.BackoffPolicy(
        base_ms=60_000, max_restarts=3), should_stop=stop.is_set)
    assert restarts == 1 and calls == [0]
    assert time.monotonic() - t0 < 5.0


def test_heartbeat_staleness_with_fake_clock():
    now = [0.0]
    hb = tres.Heartbeat(timeout_s=1.0, clock=lambda: now[0])
    assert not hb.stale()
    now[0] = 2.0
    assert hb.stale() and hb.age_s() == 2.0
    hb.beat()
    assert not hb.stale() and hb.beats == 1


def test_install_flush_handlers_one_shot():
    flushed = []
    prev = tres.install_flush_handlers(flushed.append,
                                       signals=(signal.SIGTERM,))
    try:
        with pytest.raises(SystemExit) as ei:
            signal.raise_signal(signal.SIGTERM)
        assert ei.value.code == 128 + signal.SIGTERM
        assert flushed == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is prev[signal.SIGTERM]
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)


# --- the threaded regime under a crash, lock-stepped ------------------------


def _w(pkg, v):
    if pkg is jrt:
        return {"w": jnp.full((2,), float(v))}
    return {"w": torch.full((2,), float(v))}


def _restart_script(pkg):
    """The reference's restart-provenance test, lock-stepped: the crash
    fires entering the third item; the test publishes three versions
    during the watchdog's backoff; the restarted producer's first item
    must span the outage."""
    res = jres if pkg is jrt else tres
    reg = (JRegistry if pkg is jrt else MetricsRegistry)()
    inj = res.FaultInjector("producer_crash:at_step=2", registry=reg)
    store = pkg.PolicyStore(_w(pkg, 0.0), capacity=8)
    queue = pkg.TrajectoryQueue(maxsize=2, registry=reg, injector=inj)
    entered, go = threading.Semaphore(0), threading.Semaphore(0)

    def producer(params):
        entered.release()
        assert go.acquire(timeout=WAIT)
        return float(np.asarray(params["w"])[0])

    regime = pkg.make_regime(
        "threaded", store, queue, producer, max_items=4, injector=inj,
        supervisor=res.BackoffPolicy(base_ms=400, jitter=0.0,
                                     max_restarts=2, seed=0))
    regime.start()
    items = []
    try:
        for k in range(4):
            if k == 2:
                deadline = time.monotonic() + WAIT
                while not reg.counter_values("watchdog_restart_total"):
                    assert time.monotonic() < deadline
                    time.sleep(0.002)
                for v in (1.0, 2.0, 3.0):       # inside the 400 ms backoff
                    store.publish(_w(pkg, v))
            assert entered.acquire(timeout=WAIT)
            go.release()
            item = regime.next_item(store.version, timeout=WAIT)
            items.append((item.payload, item.behavior_version,
                          item.behavior_version_newest, item.lag,
                          item.lag_newest, dict(item.meta)))
        assert regime.next_item(store.version, timeout=WAIT) is None
    finally:
        regime.stop()
    return (items, regime.restarts, inj.fired_counts(), reg.counter_values(
        "watchdog_restart_total", "restart_admitted_total",
        "fault_injected_total"))


def test_threaded_regime_restart_provenance_and_lag_spike_match_jax():
    want, got = _restart_script(jrt), _restart_script(trt)
    assert got == want
    items, restarts, fired, counters = got
    third = items[2]
    assert third[5] == {"restart": True, "restart_attempt": 1}
    assert third[1] == 0 and third[2] == 3 and third[3] == 3  # the spike
    assert restarts == 1 and fired == {"producer_crash": 1}
    assert counters["restart_admitted_total"] == 1.0


@pytest.mark.parametrize("pkg", [jrt, trt], ids=["jax", "port"])
def test_threaded_regime_restart_budget_exhaustion_surfaces(pkg):
    res = jres if pkg is jrt else tres
    inj = res.FaultInjector("producer_crash:at_step=0,count=10")
    store = pkg.PolicyStore(_w(pkg, 0.0), capacity=2)
    regime = pkg.make_regime(
        "threaded", store, pkg.TrajectoryQueue(), lambda p: 0.0,
        max_items=4, injector=inj,
        supervisor=res.BackoffPolicy(base_ms=1, max_ms=2, max_restarts=2,
                                     seed=0))
    regime.start()
    try:
        with pytest.raises(RuntimeError, match="crashed") as info:
            regime.next_item(store.version, timeout=WAIT)
        assert isinstance(regime.error, res.SupervisionError)
        assert info.value.__cause__ is regime.error
        assert regime.error.restarts == 2
    finally:
        regime.stop()
    assert inj.fired_counts() == {"producer_crash": 3}


# --- an engine stall past the request deadline -------------------------------


def _stall_script(pkg):
    res = jres if pkg is jrt else tres
    offset = [0.0]
    clock = lambda: time.monotonic() + offset[0]
    inj = res.FaultInjector(
        "stall:at_step=3,ms=120000;stall:at_step=2,slot=1,ms=5",
        sleep=lambda s: offset.__setitem__(0, offset[0] + s))
    kw = dict(num_blocks=16, block_size=4, max_batch=2, max_seq_len=32,
              temperature=0.0, seed=0, injector=inj, request_deadline_s=60.0)
    if pkg is jrt:
        eng = JaxServeEngine(JBUNDLE, JPARAMS, **kw)
    else:
        eng = ServeEngine(BUNDLE, _port(JPARAMS), device="cpu", **kw)
    eng.scheduler._clock = clock
    prompts = [np.asarray(TOK.encode(p), np.int32)
               for p in ("1+2=?#", "3*4=?#", "10-7=?#", "2+2=?#")]
    for p in prompts:
        eng.submit(p, 12)
    trajs = eng.run(max_steps=50)
    alloc = eng.allocator
    return (sorted((t.request_id, t.finish_reason, t.tokens.tolist())
                   for t in trajs),
            eng.stats.timeouts, alloc.num_blocks - alloc.num_free,
            eng.metrics.counter_values("request_timeout_total"),
            inj.fired_counts(), eng.has_work)


def test_engine_stall_past_deadline_retires_timeout_and_frees_pages():
    want, got = _stall_script(jrt), _stall_script(trt)
    assert got == want
    trajs, timeouts, used, counters, fired, has_work = got
    reasons = [r for _, r, _ in trajs]
    assert reasons.count("timeout") == timeouts == 4 - reasons.count(
        "length") - reasons.count("eos")
    assert timeouts >= 2 and "running" in str(counters)
    assert used == 0 and not has_work
    assert fired == {"stall": 2}


# --- the trainer under nan_publish and learner_nan ---------------------------

PLAN = "nan_publish:at_publish=3;learner_nan:at_step=2"


def _trainer_pair(guard_dirs):
    kw = dict(algorithm="grpo", lr=1e-3, n_minibatches=3,
              prompts_per_minibatch=2, completions_per_prompt=2,
              max_new_tokens=4, warmup_steps=1, warmup_batch=8,
              fault_plan=PLAN)
    ds = dict(prompt_len=16, level=0, pool_size=64, seed=1)
    jtr = JaxRLVRTrainer(JBUNDLE, JaxMathTaskDataset(**ds),
                         JHyperparams(**kw, guard_checkpoint_dir=guard_dirs[0]),
                         seed=0)
    tr = RLVRTrainer(BUNDLE, MathTaskDataset(**ds),
                     RLVRHyperparams(**kw, guard_checkpoint_dir=guard_dirs[1]),
                     seed=0, device="cpu", params=_port(jtr.state.params))
    from test_torch_train import _ReplayKeyChain
    tr.generator._noise = _ReplayKeyChain(1, tr.hp.max_new_tokens)
    return jtr, tr


def _consumed(trainer):
    versions = []
    next_item = trainer.regime.next_item

    def recording(*a, **k):
        item = next_item(*a, **k)
        if item is not None:
            versions.append(item.behavior_version)
        return item

    trainer.regime.next_item = recording
    return versions


@pytest.mark.parametrize("guard", ["memory", "checkpoint"])
def test_trainer_quarantines_and_restores_as_jax_does(guard, tmp_path):
    dirs = ((str(tmp_path / "jax"), str(tmp_path / "port"))
            if guard == "checkpoint" else (None, None))
    jtr, tr = _trainer_pair(dirs)
    jseen, seen = _consumed(jtr), _consumed(tr)
    assert abs(tr.warmup() - jtr.warmup()) <= 1e-4
    warm = _port(jtr.state.params)       # the RL phase from JAX's warm start
    tr.state = tr.state._replace(params=warm)
    for slot, w in zip(tree_leaves(tr.store.get(1)), tree_leaves(warm)):
        slot.copy_(w)
    logs = [(jtr.train_phase(), tr.train_phase()) for _ in range(2)]
    for (want, got), n in zip(logs, (2, 3)):
        assert len(got) == len(want) == n            # one step skipped
        for g, w in zip(got, want):
            assert (g.mean_reward, g.staleness) == (w.mean_reward,
                                                    w.staleness)
            assert abs(g.tv - w.tv) <= 1e-5
    names = ("fault_injected_total", "publish_quarantined_total",
             "learner_nonfinite_total")
    counters = tr.metrics.counter_values(*names)
    assert counters == jtr.metrics.counter_values(*names)
    assert counters[f"learner_nonfinite_total{{restored={guard}}}"] == 1.0
    assert tr.nonfinite_skipped == jtr.nonfinite_skipped == 1
    assert tr.store.quarantined_versions() == \
        jtr.store.quarantined_versions() == [3]
    assert seen == jseen and 3 not in seen            # never served
    assert tr.store.version == jtr.store.version
    assert tr.injector.fired_counts() == jtr.injector.fired_counts() == {
        "nan_publish": 1, "learner_nan": 1}
    for a, b in zip(tree_leaves(to_numpy(tr.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jtr.state.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if guard == "checkpoint":
        assert sorted(os.listdir(dirs[1])) == sorted(os.listdir(dirs[0]))
        assert latest_checkpoint(dirs[1]).endswith(
            f"{tr.state.updates}.ckpt")


# --- the threaded serve producer under the chaos plan (port) ----------------


def test_threaded_serve_chaos_plan_completes_without_leaks():
    """The chaos bench's canned plan on the threaded serve producer, cut
    to a 2-layer d 64 model on the CPU (a 2 s stall past a 0.5 s
    deadline)."""
    plan = ("producer_crash:at_step=2;stall:at_step=12,ms=2000;"
            "nan_publish:at_publish=4;queue_stall:at_call=5,ms=120;"
            "learner_nan:at_step=7")
    hp = RLVRHyperparams(
        algorithm="grpo", lr=1e-3, n_minibatches=3, prompts_per_minibatch=4,
        completions_per_prompt=4, max_new_tokens=6, warmup_steps=1,
        warmup_batch=8, producer="serve", runtime="threaded",
        queue_maxsize=2, controller="pass_through", store_capacity=6,
        engine_max_batch=8, engine_num_blocks=48, get_timeout=120.0,
        fault_plan=plan, fault_seed=0, watchdog_restarts=2,
        watchdog_backoff_ms=40.0, request_deadline_s=0.5)
    threads = {t.ident for t in threading.enumerate()}
    tr = RLVRTrainer(BUNDLE, MathTaskDataset(prompt_len=16, level=0,
                                             pool_size=256, seed=1),
                     hp, seed=0, device="cpu")
    served = set()
    put = tr.queue.put

    def audited_put(payload, **kw):
        served.update(np.unique(np.asarray(payload.versions)).tolist())
        return put(payload, **kw)

    tr.queue.put = audited_put
    tr.warmup()
    res = tr.train(5, eval_every=10**9)
    tr.close()
    alive = [t for t in threading.enumerate()
             if t.ident not in threads and t.is_alive()]
    alloc = tr.engine.allocator
    counters = tr.metrics.counter_values()
    total = lambda name: sum(v for k, v in counters.items()
                             if k.split("{")[0] == name)
    assert len(res.phase_logs) == 5 * 3 - 1           # one step skipped
    assert alloc.num_free == alloc.num_blocks and not alive
    assert sum(alloc._refs) == 0
    assert not tr.engine.has_work
    assert tr.store.quarantined_versions() == [4]
    assert not served & set(tr.store.quarantined_versions())
    assert tr.regime.restarts == total("watchdog_restart_total") == 1
    assert total("restart_admitted_total") == 1
    assert tr.engine.stats.timeouts >= 1
    assert total("learner_nonfinite_total") == tr.nonfinite_skipped == 1
    assert tr.injector.fired_counts() == {
        "producer_crash": 1, "stall": 1, "nan_publish": 1,
        "queue_stall": 1, "learner_nan": 1}


# --- checkpoints --------------------------------------------------------------


def _train_state_trees():
    """Params, and a guard checkpoint's {params, opt_state} after one
    AdamW step, as JAX and port trees."""
    jp = JPARAMS
    jopt = jax_adamw_init(jp)
    rng = np.random.default_rng(0)
    jopt = jopt._replace(
        step=jnp.asarray(5, jnp.int32),
        m=jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape), jnp.float32), jopt.m))
    p = _port(jp)
    opt = adamw_init(p)._replace(step=torch.tensor(5, dtype=torch.int32),
                                 m=_port(jopt.m))
    return {"params": (jp, p),
            "guard": ({"params": jp, "opt_state": jopt},
                      {"params": p, "opt_state": opt})}


@pytest.mark.parametrize("what", ["params", "guard"])
def test_checkpoints_cross_load_bit_equal(what, tmp_path):
    jtree, tree = _train_state_trees()[what]
    meta = {"arch": "resilience-test", "source": "finiteness_guard"}
    jpath = jax_save(str(tmp_path / "jax"), 7, jtree, meta=meta)
    path = save_checkpoint(str(tmp_path / "port"), 7, tree, meta=meta)
    with open(jpath, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()                 # the same file
    # JAX's file into the port, and the port's into JAX.
    got, step, got_meta = load_checkpoint(jpath, tree)
    want, jstep, want_meta = jax_load(path, jtree)
    assert (step, got_meta) == (jstep, want_meta) == (7, meta)
    got_leaves = tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [
        jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (_, g), (_, w), (_, orig) in zip(got_leaves, want_leaves,
                                         tree_leaves_with_path(tree)):
        assert g.dtype == orig.dtype and g.shape == orig.shape
        assert np.asarray(w).dtype == g.numpy().dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, orig)
    assert latest_checkpoint(str(tmp_path / "port")) == path
    assert latest_checkpoint(str(tmp_path / "nothing")) is None


def test_load_checkpoint_refuses_a_mismatched_tree(tmp_path):
    p = {"w": torch.ones(3), "b": torch.zeros(2)}
    path = save_checkpoint(str(tmp_path), 1, p)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, {"w": torch.ones(4), "b": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(path, {"v": torch.ones(3)})
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
