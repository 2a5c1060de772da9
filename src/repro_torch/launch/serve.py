"""Serving launcher of the port: continuous batching over the paged KV
cache, on the GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
      --requests 12 --mixed-lengths 4,8,16,32 [--full-width] [--device cpu]

Same flags and printout as ``repro.launch.serve`` for the parts ported:
the ``continuous`` engine with chunked prefill and multi-step decode.
``--full-width`` serves ``get_config("qwen2.5-0.5b")`` (24 layers, vocab
151936) instead of ``reduced_config``; the math tokenizer's ids fit in
either vocab.  Weights are a random init from ``--seed``.

Not ported yet (each exits with a message): ``--engine static``,
``--controller``, ``--speculate``, ``--prefix-cache``, ``--mesh``,
``--runtime versioned``, ``--checkpoint`` and ``--no-chunked-prefill``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_NOT_PORTED = (
    ("--engine static", lambda a: a.engine == "static"),
    ("--controller", lambda a: a.controller),
    ("--speculate", lambda a: a.speculate),
    ("--prefix-cache", lambda a: a.prefix_cache),
    ("--mesh", lambda a: a.mesh),
    ("--runtime versioned", lambda a: a.runtime == "versioned"),
    ("--checkpoint", lambda a: a.checkpoint),
    ("--no-chunked-prefill", lambda a: a.no_chunked_prefill),
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-0.5b")
    ap.add_argument("--engine", default="static",
                    choices=["static", "continuous"],
                    help="continuous: paged-KV continuous batching "
                         "(static is not ported yet)")
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
    ap.add_argument("--speculate", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--best-of", type=int, default=1,
                    help="continuous: submit each prompt N times")
    ap.add_argument("--no-chunked-prefill", action="store_true")
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
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runtime", default="direct",
                    choices=["direct", "versioned"])
    ap.add_argument("--controller", default=None, metavar="SPEC")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append one metrics-registry snapshot as a "
                         "JSONL line at exit")
    return ap


def prepare(args: argparse.Namespace, tracer: Any = None
            ) -> Tuple[Any, Dict[int, Tuple[str, str]]]:
    """Build the model and engine from ``args`` and submit the math
    prompts; returns ``(engine, {request_id: (prompt, answer)})``."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build
    from repro_torch.serve import ServeEngine, resolve_device

    device = resolve_device(args.device)
    tok = get_tokenizer()
    cfg = (get_config(args.arch) if args.full_width
           else reduced_config(args.arch, vocab=tok.vocab_size))
    bundle = build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = bundle.init(gen, device=device)
    ds = MathTaskDataset(prompt_len=32, level=args.level, seed=args.seed + 1)

    lengths = [int(x) for x in args.mixed_lengths.split(",")] \
        if args.mixed_lengths else [args.max_new_tokens]
    engine = ServeEngine(
        bundle, params, num_blocks=args.num_blocks,
        block_size=args.block_size, max_batch=args.max_batch,
        max_seq_len=args.max_seq_len, decode_chunk=args.decode_chunk,
        temperature=args.temperature, top_p=args.top_p, seed=args.seed + 2,
        prefill_chunk=args.prefill_chunk,
        dispatch_budget=args.dispatch_budget, tracer=tracer,
        annotate=args.profiler_annotations, device=device)
    toks_np, prompts, answers = ds.sample_batch(args.requests)
    meta = {}
    for i in range(args.requests):
        row = toks_np[i]
        row = row[row != tok.pad_id]            # ragged: true prompt only
        for _ in range(max(args.best_of, 1)):
            req = engine.submit(row, lengths[i % len(lengths)])
            meta[req.request_id] = (prompts[i], answers[i])
    return engine, meta


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
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "this host's CPU")
    print(f"continuous decode: {n_tok} tokens / {len(trajs)} requests in "
          f"{dt*1e3:.1f} ms ({n_tok/dt:.0f} tok/s on {where})")
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
    for t in sorted(trajs, key=lambda t: t.request_id)[:8]:
        _, ans = meta[t.request_id]
        text = tok.decode(t.tokens)
        r = verify(text, ans)
        print(f"  [{t.request_id}] -> {text!r} ({t.num_tokens} tok, "
              f"{t.finish_reason}, gold {ans}, reward {r})")


def serve(args: argparse.Namespace, tracer: Any = None
          ) -> Tuple[Any, List[Any], float]:
    """Build, serve and report; returns ``(engine, trajectories,
    seconds)``."""
    engine, meta = prepare(args, tracer)
    trajs, dt = run(args, engine)
    report(args, engine, trajs, dt, meta)
    return engine, trajs, dt


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.requests is None:
        args.requests = args.batch
    for flag, on in _NOT_PORTED:
        if on(args):
            raise SystemExit(f"{flag} is not ported to the PyTorch serve "
                             "path yet; use repro.launch.serve for it")

    from repro_torch.obs.tracer import make_tracer

    tracer = make_tracer(args.trace_detail if args.trace else "off")
    engine, _, _ = serve(args, tracer=tracer)
    if args.trace:
        from repro_torch.obs.perfetto import (export_perfetto,
                                              export_trace_jsonl)

        if args.trace.endswith(".jsonl"):
            n = export_trace_jsonl(tracer, args.trace)
        else:
            n = export_perfetto(tracer, args.trace)
        print(f"trace: {n} events -> {args.trace} "
              f"(detail={args.trace_detail}, "
              f"ring-dropped={tracer.dropped})")
    if args.metrics_out:
        engine.metrics.export_jsonl(args.metrics_out)
        print(f"metrics: snapshot -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
