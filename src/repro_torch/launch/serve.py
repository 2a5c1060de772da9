"""Serving launcher of the port, on the GPU by default.

  # static: one batch of prompts, prefill + one-token decode steps
  PYTHONPATH=src python -m repro_torch.launch.serve --engine static \\
      --arch hymba-1.5b --batch 8 --max-new-tokens 16 [--full-width] \\
      [--device cpu]

  # continuous batching over the paged KV cache (dense archs)
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --requests 12 --mixed-lengths 4,8,16,32 [--full-width] [--device cpu]

  # the deprecated batched prefill (one dispatch per padded length)
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --no-chunked-prefill [--no-batch-prefill] [--full-width] [--device cpu]

  # speculative decode from the store's lagged version, prefix cache
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --runtime versioned --speculate 4 --draft version:-1 \\
      --prefix-cache --best-of 4 [--full-width] [--device cpu]

Same flags and printout as ``repro.launch.serve`` for the parts ported:
the ``static`` engine (``rollout.sampler.generate`` over the decode
cache: one untimed warm call, then one call timed between device
synchronisations) for every arch the port has, and the ``continuous``
engine with chunked prefill (or the deprecated batched prefill,
``--no-chunked-prefill``, ``--no-batch-prefill``), multi-step decode,
speculative decode
(``--speculate k``, ``--draft version:-n|model:<arch>|self``,
``--speculate-adaptive``) and the prefix cache (``--prefix-cache``),
which refuses attention-free and hybrid archs as the reference's engine
does.  ``--runtime versioned`` serves through a ``PolicyStore`` holding
the init as v0 and the ``--checkpoint`` (when given) as v1; the
continuous engine polls it every ``--swap-interval`` steps.
``--controller SPEC`` (continuous only) replays the retired requests
through a lag controller's admission hook and prints its verdicts
(shadow scoring: nothing is dropped).
``--full-width`` serves ``get_config(--arch)`` (qwen2.5-0.5b: 24 layers,
vocab 151936; qwen2.5-14b: 48 layers, d 5120, 40 / 8 heads of 128,
vocab 152064, 14.77 B params, 59.1 GB in float32; codeqwen1.5-7b: 32
layers, d 4096, 32 / 32 heads of 128, vocab 92416, 8.19 B params, 32.8
GB; gemma3-12b: 48 layers, d 3840, 16 / 8 heads of 256, d_ff 15360,
vocab 262144, tied embeddings, logits soft-capped at 30, a window of
1024 keys on five layers of six, 11.77 B params, 43.8 GiB in float32;
rwkv6-1.6b: 24 layers, d 2048, vocab 65536; hymba-1.5b: 32 layers,
d 1600, vocab 32001) instead of ``reduced_config``; the math
tokenizer's ids fit in every vocab.  gemma3-12b's pool holds 0.75 MiB a
token (48 layers x 8 kv heads x 256 x 4 B x 2): the default 128 blocks
of 8 take 768 MiB; size ``--num-blocks`` / ``--max-seq-len`` for long
prompts (a 2,048-token prompt: 257 blocks, 1.5 GiB).
Weights are a random init from ``--seed``, or the checkpoint
``--checkpoint`` names (``repro_torch.checkpoint``, the format
``repro.checkpoint`` writes; e.g. what ``train rlvr --checkpoint-dir``
saved), loaded into that init's structure.  SIGINT/SIGTERM flush the
trace and metrics before exiting.

Not ported yet (exits with a message): ``--mesh``.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time
from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

_NOT_PORTED = (
    ("--mesh", lambda a: a.mesh),
)


def _version_tag(versions) -> str:
    """Human summary of one request's per-token version vector."""
    uniq = sorted(set(int(v) for v in versions))
    if len(uniq) == 1:
        return f"v{uniq[0]}"
    return f"v{uniq[0]}->v{uniq[-1]}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-0.5b")
    ap.add_argument("--engine", default="static",
                    choices=["static", "continuous"],
                    help="static: phase-locked batch generate(); "
                         "continuous: paged-KV continuous batching")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full config (get_config) instead of "
                         "the reduced one")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=None,
                    help="continuous: total requests (default --batch)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--mixed-lengths", default=None,
                    help="continuous: comma list of per-request "
                         "max-new-tokens, cycled (e.g. 4,8,16,32)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous: decode slots")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--decode-chunk", type=int, default=4,
                    help="continuous: decode steps per dispatch "
                         "(scheduling happens between chunks)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="continuous: speculative-decode draft length k "
                         "(0 = off); k drafted tokens are verified in "
                         "one multi-token pass")
    ap.add_argument("--draft", default="version:-1",
                    help="draft policy: version:-n (self-speculation "
                         "from the PolicyStore, needs --runtime "
                         "versioned), model:<arch> (small registry "
                         "draft), self (verifier params; accept-all)")
    ap.add_argument("--speculate-adaptive", action="store_true",
                    help="continuous: adapt the per-round draft length "
                         "in [1, --speculate] from each slot's "
                         "acceptance EMA")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous: share resident prompt-prefix KV "
                         "pages across requests (refcounted, copy-on-"
                         "write); prefill runs only the unmatched suffix")
    ap.add_argument("--best-of", type=int, default=1,
                    help="continuous: submit each prompt N times (the "
                         "access pattern --prefix-cache collapses to ~1x "
                         "prefill)")
    ap.add_argument("--no-batch-prefill", action="store_true",
                    help="continuous: prefill admissions one dispatch "
                         "per request (default stacks same-padded-"
                         "length admissions)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="continuous: disable chunked ragged prefill "
                         "and fall back to the DEPRECATED batched "
                         "prefill path (one blocking dispatch per "
                         "padded-length group)")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="continuous: rows per prefill tile in the "
                         "unified varlen dispatch (chunked prefill)")
    ap.add_argument("--dispatch-budget", type=int, default=32,
                    help="continuous: max tokens per unified dispatch "
                         "while prefills are pending (decode rows are "
                         "reserved first)")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write an execution trace: .json -> Chrome/"
                         "Perfetto trace_event format, .jsonl -> flat "
                         "event lines")
    ap.add_argument("--trace-detail", default="spans",
                    choices=["off", "spans", "full"])
    ap.add_argument("--profiler-annotations", action="store_true",
                    help="wrap engine dispatches in torch.profiler."
                         "record_function")
    ap.add_argument("--swap-interval", type=int, default=1,
                    help="continuous, --runtime versioned: steps between "
                         "polls of the store's newest version")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runtime", default="direct",
                    choices=["direct", "versioned"],
                    help="versioned: serve through the PolicyStore (v0 "
                         "the init, v1 the --checkpoint)")
    ap.add_argument("--controller", default=None, metavar="SPEC",
                    help="continuous: shadow-evaluate a lag controller "
                         "('name:key=val,...', the training launcher's "
                         "grammar) over the retired requests: verdicts "
                         "and reasons only, nothing dropped")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append one metrics-registry snapshot as a "
                         "JSONL line at exit")
    return ap


def _where(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "this host's CPU")


def _model(args: argparse.Namespace, tracer: Any = None):
    """``(device, bundle, params, dataset, store)`` from ``args``: the
    config, its random init from ``--seed`` on the device (or
    ``--checkpoint`` loaded into it), the math prompts, and with
    ``--runtime versioned`` a ``PolicyStore`` on the device holding the
    init as v0 and the checkpoint, when given, as v1 (else None)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build
    from repro_torch.serve import resolve_device

    device = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.full_width
           else reduced_config(args.arch, vocab=get_tokenizer().vocab_size))
    bundle = build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params = bundle.init(gen, device=device)
    if args.checkpoint:
        from repro_torch.checkpoint import load_checkpoint

        params, step, meta = load_checkpoint(args.checkpoint, params)
        print(f"loaded checkpoint step={step} meta={meta}")
    store = None
    if args.runtime == "versioned":
        from repro_torch.runtime import PolicyStore
        from repro_torch.obs.tracer import NULL_TRACER

        # v0 is the true random init; the checkpoint (if any) is v1.
        store = PolicyStore(init_params, capacity=2,
                            meta={"source": "init"},
                            tracer=tracer if tracer is not None
                            else NULL_TRACER)
        if args.checkpoint:
            store.publish(params, source="checkpoint",
                          checkpoint=args.checkpoint)
    ds = MathTaskDataset(prompt_len=32, level=args.level, seed=args.seed + 1)
    return device, bundle, params, ds, store


def _parse_draft(spec: str, args: argparse.Namespace, params: Any,
                 device: torch.device):
    """--draft grammar: ``version:-n`` (self-speculation from the
    PolicyStore ring), ``model:<arch>`` (the reduced registry config of
    ``arch``, random init from ``--seed`` + 7), ``self`` (the verifier's
    own params; the accept-all ceiling)."""
    if spec.startswith("version:"):
        return ("version", int(spec.split(":", 1)[1]))
    if spec.startswith("model:"):
        from repro_torch.configs import reduced_config
        from repro_torch.data.tokenizer import get_tokenizer
        from repro_torch.models.registry import build

        dcfg = reduced_config(spec.split(":", 1)[1],
                              vocab=get_tokenizer().vocab_size)
        dbundle = build(dcfg)
        gen = torch.Generator(device=device).manual_seed(args.seed + 7)
        return ("model", dbundle, dbundle.init(gen, device=device))
    if spec == "self":
        return ("params", params)
    raise SystemExit(f"--draft {spec!r}: want version:-n, model:<arch> "
                     "or self")


class StaticServe(NamedTuple):
    """One static batch: the model, the left-padded prompts ``[B, 32]``
    on the device, their answers, and ``generate`` bound to them;
    ``version`` is the store version served (``--runtime versioned``)."""
    device: torch.device
    bundle: Any
    params: Any
    prompts: torch.Tensor
    answers: List[str]
    generate: Callable[[], Any]
    version: Optional[int] = None


def prepare_static(args: argparse.Namespace) -> StaticServe:
    """Build the model and draw ``--batch`` math prompts.  Each call of
    ``generate`` samples with a generator seeded from ``--seed``, so
    every call draws the same tokens, as the JAX launcher's fixed key
    does."""
    from repro_torch.rollout.sampler import generate

    device, bundle, params, ds, store = _model(args)
    version = None
    if store is not None:
        params, version = store.latest()
        print(f"serving policy version {version} "
              f"(retained: {store.retained_versions()})")
    toks_np, _, answers = ds.sample_batch(args.batch)
    prompts = torch.from_numpy(toks_np).to(device)

    def gen_fn():
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        return generate(bundle, params, prompts, gen,
                        max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, top_p=args.top_p)

    return StaticServe(device, bundle, params, prompts, answers, gen_fn,
                       version)


def run_static(static: StaticServe) -> Tuple[Any, float]:
    """One ``generate`` timed between device synchronisations; returns
    ``(GenerationResult, seconds)``."""
    sync = (torch.cuda.synchronize if static.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.time()
    res = static.generate()
    sync()
    return res, time.time() - t0


def report_static(static: StaticServe, res: Any, dt: float) -> None:
    """The run's summary, in the JAX launcher's format."""
    from repro_torch.data.mathgen import verify
    from repro_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    n_tok = res.completion.numel()
    tag = ("" if static.version is None
           else f" [policy v{static.version}]")
    print(f"decode: {n_tok} tokens in {dt*1e3:.1f} ms "
          f"({n_tok/dt:.0f} tok/s on {_where(static.device)}){tag}")
    comp = res.completion.cpu().numpy()
    for i in range(min(len(static.answers), 8)):
        text = tok.decode(comp[i])
        r = verify(text, static.answers[i])
        print(f"  [{i}] -> {text!r} (gold {static.answers[i]}, "
              f"reward {r}){tag}")


def serve_static(args: argparse.Namespace) -> Tuple[StaticServe, Any, float]:
    """Build, warm (one untimed ``generate``), serve timed and report;
    returns ``(static, result, seconds)``."""
    static = prepare_static(args)
    static.generate()
    res, dt = run_static(static)
    report_static(static, res, dt)
    return static, res, dt


def make_engine(args: argparse.Namespace, bundle: Any, params: Any,
                store: Any, device: torch.device, tracer: Any = None):
    """The continuous engine ``args`` describe over one model (what
    :func:`_model` built): several engines can serve the same params."""
    from repro_torch.serve import ServeEngine

    draft = None
    if args.speculate:
        draft = _parse_draft(args.draft, args, params, device)
    return ServeEngine(
        bundle, params if store is None else None, store=store,
        num_blocks=args.num_blocks,
        block_size=args.block_size, max_batch=args.max_batch,
        max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
        swap_interval=args.swap_interval,
        temperature=args.temperature, top_p=args.top_p, seed=args.seed + 2,
        speculate_k=args.speculate, draft=draft,
        batch_prefill=not args.no_batch_prefill,
        chunked_prefill=not args.no_chunked_prefill,
        prefill_chunk=args.prefill_chunk,
        dispatch_budget=args.dispatch_budget,
        speculate_adaptive=args.speculate_adaptive,
        prefix_cache=args.prefix_cache, tracer=tracer,
        annotate=args.profiler_annotations, device=device)


def submit_batch(args: argparse.Namespace, engine: Any,
                 batch: Tuple[Any, List[str], List[str]]
                 ) -> Dict[int, Tuple[str, str]]:
    """Submit ``batch`` (``MathTaskDataset.sample_batch(args.requests)``)
    as ragged prompts, each ``--best-of`` times, with the
    ``--mixed-lengths`` budgets; returns ``{request_id: (prompt,
    answer)}``."""
    from repro_torch.data.tokenizer import get_tokenizer

    tok = get_tokenizer()
    lengths = [int(x) for x in args.mixed_lengths.split(",")] \
        if args.mixed_lengths else [args.max_new_tokens]
    toks_np, prompts, answers = batch
    meta = {}
    for i in range(args.requests):
        row = toks_np[i]
        row = row[row != tok.pad_id]            # ragged: true prompt only
        for _ in range(max(args.best_of, 1)):
            req = engine.submit(row, lengths[i % len(lengths)])
            meta[req.request_id] = (prompts[i], answers[i])
    return meta


def prepare(args: argparse.Namespace, tracer: Any = None
            ) -> Tuple[Any, Dict[int, Tuple[str, str]]]:
    """Build the model and continuous engine from ``args`` and submit the
    math prompts; returns ``(engine, {request_id: (prompt, answer)})``."""
    device, bundle, params, ds, store = _model(args, tracer)
    engine = make_engine(args, bundle, params, store, device, tracer)
    return engine, submit_batch(args, engine, ds.sample_batch(args.requests))


def run(args: argparse.Namespace, engine: Any) -> Tuple[List[Any], float]:
    """Serve every submitted request; returns (trajectories, seconds),
    timed between device synchronisations."""
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.time()
    trajs = engine.run(max_steps=args.max_steps)
    sync()
    return trajs, time.time() - t0


def report(args: argparse.Namespace, engine: Any, trajs: List[Any],
           dt: float, meta: Dict[int, Tuple[str, str]]) -> None:
    """The run's summary, in the JAX launcher's format."""
    from repro_torch.data.mathgen import verify
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.metrics.runtime_metrics import collect_serve_stats

    tok = get_tokenizer()
    stats = collect_serve_stats(engine)
    n_tok = stats["tokens_out"]
    print(f"continuous decode: {n_tok} tokens / {len(trajs)} requests in "
          f"{dt*1e3:.1f} ms ({n_tok/dt:.0f} tok/s on {_where(engine.device)})")
    lat_tag = "latency n/a (nothing retired; raise --max-steps)"
    if stats["request_latency_count"]:
        lat_tag = (f"latency p50 {stats['request_latency_p50_ms']:.1f} ms "
                   f"p99 {stats['request_latency_p99_ms']:.1f} ms")
    print(f"  occupancy {stats['mean_occupancy']:.2f}/{args.max_batch}, "
          f"prefills {stats['prefills']} "
          f"({stats['prefill_dispatches']} dispatches), "
          f"preemptions {stats['preemptions']}, swaps {stats['swaps']}, "
          f"{lat_tag}")
    if stats["ttft_count"]:
        print(f"  ttft p50 {stats['ttft_p50_ms']:.1f} ms "
              f"p99 {stats['ttft_p99_ms']:.1f} ms, inter-token p50 "
              f"{stats['inter_token_p50_ms']:.2f} ms p99 "
              f"{stats['inter_token_p99_ms']:.2f} ms, queue-wait p50 "
              f"{stats['queue_wait_p50_ms']:.1f} ms")
    if stats.get("prefix_cache"):
        print(f"  prefix cache: hit rate "
              f"{stats['prefix_hit_rate']:.2f} "
              f"({stats['prefix_hits']}/{stats['prefix_queries']} "
              f"admissions), token hit rate "
              f"{stats['prefix_token_hit_rate']:.2f} "
              f"({stats['prefix_matched_tokens']} matched / "
              f"{stats['prefill_tokens']} computed), "
              f"cow copies {stats['cow_copies']}, "
              f"cached pages {stats['cached_pages']}, "
              f"evictions {stats['cache_evictions']}")
    if "reclaimed_window_pages" in stats:
        print(f"  window reclamation (W={stats['reclaim_window']}): "
              f"{stats['reclaimed_window_pages']} pages released")
    if args.speculate:
        dv = stats.get("draft_version")
        dtag = ("oracle/callable" if dv is None and engine.draft is not None
                and not hasattr(engine.draft, "pages")
                else f"v{dv}" if dv is not None else "fixed-params")
        print(f"  speculative k={args.speculate}: acceptance "
              f"{stats['acceptance_rate']:.2f} "
              f"({stats['accepted_tokens']}/{stats['drafted_tokens']} "
              f"drafted), draft {dtag}, lag hist "
              f"{stats.get('draft_version_lag_histogram', {})}")
        if args.speculate_adaptive:
            print(f"  adaptive k in [1, {args.speculate}]: chosen-k "
                  f"histogram {stats.get('chosen_k_histogram', {})}")
    for t in sorted(trajs, key=lambda t: t.request_id)[:8]:
        _, ans = meta[t.request_id]
        text = tok.decode(t.tokens)
        r = verify(text, ans)
        vtag = ("" if engine.store is None
                else f" [policy {_version_tag(t.versions)}]")
        print(f"  [{t.request_id}] -> {text!r} ({t.num_tokens} tok, "
              f"{t.finish_reason}, gold {ans}, reward {r}){vtag}")


def shadow_admission(args: argparse.Namespace, engine: Any,
                     trajs: List[Any]) -> List[Tuple[int, str, str, Any]]:
    """Replay retired trajectories through the ``--controller`` lag
    controller's admission hook, verdict only (nothing is removed from
    the serve output), as ``repro.launch.serve`` does.  ``tv_gate``
    scores each request's completion against the latest policy (the
    store head under ``--runtime versioned``, else the engine's params)
    through ``score_tokens`` (the fused log-prob kernel on the card);
    ``tv_gate_tokenwise`` also segments by the request's own per-token
    versions.  Verdicts land on the engine's metrics registry as
    ``serve_shadow_admission_total{controller,outcome,reason}``; returns
    each request's ``(request_id, outcome, reason, tv)``."""
    import numpy as np

    from repro_torch.core.tv_filter import tv_estimate
    from repro_torch.rollout.sampler import score_tokens
    from repro_torch.runtime import make_controller, parse_controller_spec
    from repro_torch.runtime.queue import TrajectoryItem

    spec = parse_controller_spec(args.controller)
    store, device = engine.store, engine.device
    ref_version = store.version if store is not None else engine.version

    def _score(traj):
        params = store.latest()[0] if store is not None else engine.params
        row = np.concatenate([np.asarray(traj.prompt),
                              np.asarray(traj.tokens)])
        with torch.no_grad():
            log_pi, _, _ = score_tokens(
                engine.bundle, params,
                torch.as_tensor(row, device=device)[None, :],
                len(traj.prompt))
        return log_pi

    def tv_fn(traj):
        log_pi = _score(traj)
        on = lambda a: torch.as_tensor(np.asarray(a), device=device)[None, :]
        return float(tv_estimate(log_pi - on(traj.log_beta), on(traj.mask)))

    def token_tv_fn(traj):
        log_pi = _score(traj)[0].cpu().numpy()
        tv = 0.5 * np.abs(np.exp(log_pi - np.asarray(traj.log_beta)) - 1.0)
        valid = np.asarray(traj.mask) > 0
        return tv[valid], np.asarray(traj.versions)[valid]

    controller = make_controller(spec, tv_fn=tv_fn, token_tv_fn=token_tv_fn)
    decisions = []
    for t in trajs:
        versions = np.asarray(t.versions)
        oldest = int(versions.min()) if versions.size else ref_version
        newest = int(versions.max()) if versions.size else ref_version
        item = TrajectoryItem(
            payload=t, behavior_version=oldest,
            enqueue_learner_version=ref_version,
            behavior_version_newest=newest)
        item.learner_version_at_consume = ref_version
        d = controller.admit(item)
        outcome = ("drop" if not d.admit
                   else "admit" if d.weight == 1.0 else "downweight")
        decisions.append((t.request_id, outcome, d.reason, d.tv))
        engine.metrics.counter(
            "serve_shadow_admission_total", controller=controller.name,
            outcome=outcome, reason=d.reason).inc()
    total = len(trajs)
    counts = Counter((outcome, reason) for _, outcome, reason, _ in decisions)
    print(f"  shadow controller {spec.canonical()!r} over {total} "
          f"retired requests (verdict-only, nothing dropped):")
    for (outcome, reason), n in sorted(counts.items()):
        print(f"    {outcome:<10} reason={reason:<24} {n}/{total}")
    return decisions


def serve(args: argparse.Namespace, tracer: Any = None,
          flush_state: Optional[dict] = None
          ) -> Tuple[Any, List[Any], float]:
    """Build, serve and report; returns ``(engine, trajectories,
    seconds)``.  ``flush_state["engine"]`` is set as soon as the engine
    exists (for the signal flush)."""
    engine, meta = prepare(args, tracer)
    if flush_state is not None:
        flush_state["engine"] = engine
    trajs, dt = run(args, engine)
    report(args, engine, trajs, dt, meta)
    if args.controller:
        shadow_admission(args, engine, trajs)
    return engine, trajs, dt


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.requests is None:
        args.requests = args.batch
    for flag, on in _NOT_PORTED:
        if on(args):
            raise SystemExit(f"{flag} is not ported to the PyTorch serve "
                             "path yet; use repro.launch.serve for it")
    if args.controller and args.engine != "continuous":
        raise SystemExit("--controller needs --engine continuous "
                         "(shadow admission runs over retired requests)")

    from repro_torch.obs.tracer import make_tracer
    from repro_torch.resilience import install_flush_handlers

    tracer = make_tracer(args.trace_detail if args.trace else "off")

    def _export_trace() -> None:
        if not args.trace:
            return
        from repro_torch.obs.perfetto import (export_perfetto,
                                              export_trace_jsonl)

        if args.trace.endswith(".jsonl"):
            n = export_trace_jsonl(tracer, args.trace)
        else:
            n = export_perfetto(tracer, args.trace)
        print(f"trace: {n} events -> {args.trace} "
              f"(detail={args.trace_detail}, "
              f"ring-dropped={tracer.dropped})")

    # SIGINT/SIGTERM still leave the trace and metrics on disk.
    flush_state = {"engine": None}

    def _flush(signum: int) -> None:
        engine = flush_state.get("engine")
        if engine is not None and args.metrics_out:
            engine.metrics.export_jsonl(args.metrics_out, signal=signum)
            print(f"metrics: flushed -> {args.metrics_out}")
        _export_trace()

    previous = install_flush_handlers(_flush)
    try:
        engine = None
        if args.engine == "static":
            serve_static(args)
        else:
            engine, _, _ = serve(args, tracer, flush_state)
        _export_trace()
        if args.metrics_out and engine is not None:   # as in JAX
            engine.metrics.export_jsonl(args.metrics_out)
            print(f"metrics: snapshot -> {args.metrics_out}")
        return 0
    finally:
        # The handlers close over this run: put back what was there.
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
