"""Training launcher of the port: forward-lag RLVR (§5.2) on the GPU by
default.

  PYTHONPATH=src python -m repro_torch.launch.train rlvr \\
      --algorithm grpo_vaco --n-minibatches 4 --phases 10 \\
      [--full-width] [--device cpu]

Same flags and printout as ``repro.launch.train rlvr`` for the parts
ported: the legacy producer (``ForwardLagGenerator``) under the
``forward_n`` runtime, with the ``pass_through``, ``max_lag``,
``tv_gate`` and ``tv_gate_tokenwise`` controllers.  ``--full-width``
trains ``get_config("qwen2.5-0.5b")`` (24 layers, vocab 151936) instead of
``reduced_config``; the math tokenizer's ids fit in either vocab.
Weights are a random init from ``--seed``.

Not ported yet (each exits with a message): the ``rl`` subcommand,
``--producer serve``, ``--runtime threaded``, the controllers ``gac``,
``stable_async`` and ``asympo``, ``--fault-plan``,
``--watchdog-restarts``, ``--request-deadline``, ``--checkpoint-dir``
and ``--guard-checkpoint-dir``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Optional

_NOT_PORTED = (
    ("--producer serve", lambda a: a.producer == "serve"),
    ("--runtime threaded", lambda a: a.runtime == "threaded"),
    ("--fault-plan", lambda a: a.fault_plan),
    ("--watchdog-restarts", lambda a: a.watchdog_restarts > 0),
    ("--request-deadline", lambda a: a.request_deadline is not None),
    ("--checkpoint-dir", lambda a: a.checkpoint_dir),
    ("--guard-checkpoint-dir", lambda a: a.guard_checkpoint_dir),
    ("--forced-lag", lambda a: a.forced_lag is not None),
)
_CONTROLLERS_NOT_PORTED = ("gac", "stable_async", "asympo")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("rl", help="simulated-async classic RL (not ported yet)")
    rv = sub.add_parser("rlvr", help="forward-lag RLVR (§5.2)")
    rv.add_argument("--arch", default="qwen2.5-0.5b")
    rv.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rv.add_argument("--full-width", action="store_true",
                    help="train the full config (get_config) instead of "
                         "the reduced one")
    rv.add_argument("--algorithm", default="grpo_vaco",
                    choices=["grpo", "grpo_vaco"])
    rv.add_argument("--n-minibatches", type=int, default=4)
    rv.add_argument("--phases", type=int, default=10)
    rv.add_argument("--level", type=int, default=0,
                    help="math curriculum level")
    rv.add_argument("--warmup-steps", type=int, default=300)
    rv.add_argument("--seed", type=int, default=0)
    rv.add_argument("--delta", type=float, default=0.05)
    rv.add_argument("--checkpoint-dir", default=None)
    rv.add_argument("--producer", default="legacy",
                    choices=["legacy", "serve"])
    rv.add_argument("--forced-lag", type=int, default=None)
    rv.add_argument("--max-new-tokens", type=int, default=None,
                    help="completion length (default: hp default)")
    rv.add_argument("--engine-max-batch", type=int, default=8)
    rv.add_argument("--fault-plan", default="", metavar="PLAN")
    rv.add_argument("--fault-seed", type=int, default=0)
    rv.add_argument("--watchdog-restarts", type=int, default=0)
    rv.add_argument("--watchdog-backoff-ms", type=float, default=50.0)
    rv.add_argument("--request-deadline", type=float, default=None,
                    metavar="SECONDS")
    rv.add_argument("--no-finiteness-guard", action="store_true",
                    help="disable the NaN/Inf firewall (non-finite "
                         "publishes quarantined, non-finite learner "
                         "steps skipped + rolled back)")
    rv.add_argument("--guard-checkpoint-dir", default=None)
    rv.add_argument("--runtime", default="forward_n",
                    choices=["forward_n", "threaded"],
                    help="lag regime driving the actor-learner runtime")
    rv.add_argument("--controller", default=None, metavar="SPEC",
                    help="lag controller spec 'name:key=val,...', e.g. "
                         "'tv_gate:delta=0.2,mode=downweight'")
    rv.add_argument("--admission", default=None,
                    choices=["pass_through", "max_lag", "tv_gate",
                             "tv_gate_tokenwise"],
                    help="DEPRECATED: use --controller 'name:...'")
    rv.add_argument("--max-lag", type=int, default=None,
                    help="DEPRECATED: use --controller 'max_lag:max_lag=N'")
    rv.add_argument("--admission-mode", default=None,
                    choices=["drop", "downweight"],
                    help="DEPRECATED: use --controller "
                         "'tv_gate:delta=...,mode=...'")
    rv.add_argument("--queue-maxsize", type=int, default=4)
    rv.add_argument("--trace", default=None, metavar="PATH",
                    help="write an execution trace: .json -> Perfetto, "
                         ".jsonl -> flat event lines")
    rv.add_argument("--trace-detail", default="spans",
                    choices=["off", "spans", "full"])
    rv.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append one metrics-registry snapshot as a JSONL "
                         "line at exit")
    return ap


def _resolve_controller(args, *, delta):
    """Controller spec text from --controller or the deprecated
    --admission/--max-lag/--admission-mode flags.  None = the default."""
    legacy_used = (args.admission is not None or args.max_lag is not None
                   or args.admission_mode is not None)
    if args.controller is not None:
        if legacy_used:
            raise SystemExit(
                "--controller conflicts with the deprecated --admission/"
                "--max-lag/--admission-mode flags; pass one or the other")
        return args.controller
    if not legacy_used:
        return None
    from repro_torch.runtime import spec_from_legacy

    return spec_from_legacy(
        args.admission or "pass_through",
        max_lag=args.max_lag if args.max_lag is not None else 4,
        delta=delta, mode=args.admission_mode or "drop",
        warn=True).canonical()


def _refuse_unported(args) -> None:
    if args.mode == "rl":
        raise SystemExit("the rl subcommand is not ported to the PyTorch "
                         "launcher yet; use repro.launch.train rl")
    for flag, on in _NOT_PORTED:
        if on(args):
            raise SystemExit(f"{flag} is not ported to the PyTorch trainer "
                             "yet; use repro.launch.train for it")
    name = (args.controller or "").split(":")[0].strip()
    if name in _CONTROLLERS_NOT_PORTED:
        raise SystemExit(f"--controller {name} is not ported to the "
                         "PyTorch trainer yet; use repro.launch.train for it")


def build_trainer(args, tracer: Any = None):
    """The trainer ``args`` describe (model, dataset, hyperparameters)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.data.tokenizer import get_tokenizer
    from repro_torch.models.registry import build
    from repro_torch.train import RLVRHyperparams, RLVRTrainer

    tok = get_tokenizer()
    cfg = (get_config(args.arch) if args.full_width
           else reduced_config(args.arch, vocab=tok.vocab_size))
    ds = MathTaskDataset(prompt_len=32, level=args.level)
    hp_kwargs = dict(
        algorithm=args.algorithm, n_minibatches=args.n_minibatches,
        warmup_steps=args.warmup_steps, delta=args.delta,
        runtime=args.runtime,
        controller=_resolve_controller(args, delta=args.delta),
        finiteness_guard=not args.no_finiteness_guard)
    if args.max_new_tokens is not None:
        hp_kwargs["max_new_tokens"] = args.max_new_tokens
    return RLVRTrainer(build(cfg), ds, RLVRHyperparams(**hp_kwargs),
                       seed=args.seed, tracer=tracer, device=args.device)


def run(args, tracer: Any = None):
    """Warmup, train and print, as the JAX launcher does; returns
    ``(trainer, result, warmup_loss)``."""
    trainer = build_trainer(args, tracer)
    wl = trainer.warmup()
    print(f"[warmup] loss={wl:.4f} acc={trainer.evaluate(128):.3f}")
    res = trainer.train(args.phases, eval_every=max(args.phases // 4, 1))
    step_summary = trainer.metrics.histogram("train_step_s").summary()
    print(json.dumps({
        "arch": trainer.bundle.cfg.name,
        "algorithm": args.algorithm,
        "runtime": args.runtime,
        "n_minibatches": args.n_minibatches,
        "eval_accuracy": res.eval_accuracy,
        "final_tv": res.phase_logs[-1].tv if res.phase_logs else None,
        "runtime_stats": res.runtime_stats,
        "train_step_ms": {
            "count": step_summary["count"],
            "mean": step_summary["mean"] * 1e3,
            "p50": step_summary["p50"] * 1e3,
            "p99": step_summary["p99"] * 1e3,
        },
    }, indent=1))
    return trainer, res, wl


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    from repro_torch.obs.tracer import make_tracer

    tracer = make_tracer(args.trace_detail if args.trace else "off")
    trainer, _, _ = run(args, tracer)
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
        trainer.metrics.export_jsonl(args.metrics_out)
        print(f"metrics: snapshot -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
