"""Training launcher of the port, on the GPU by default: simulated-async
classic RL (§5.1) and forward-lag RLVR (§5.2).

  # classic RL: VACO over a 4-snapshot backward mixture, paper scale
  PYTHONPATH=src python -m repro_torch.launch.train rl \\
      --env pendulum --algorithm vaco --buffer-capacity 4 \\
      --n-actors 500 --rollout-steps 1000 --phases 30 [--device cpu]

  # RLVR: GRPO+VACO on qwen2.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.train rlvr \\
      --algorithm grpo_vaco --n-minibatches 4 --phases 10 \\
      [--full-width] [--device cpu]

  # RLVR with the ServeEngine as the rollout producer: real per-token
  # {version, log_beta} provenance under a scripted 2-back lag
  PYTHONPATH=src python -m repro_torch.launch.train rlvr \\
      --producer serve --forced-lag 2 \\
      --controller "tv_gate:delta=0.05,mode=downweight" --phases 10

  # either, with a producer thread: lag from timing, a bounded queue
  PYTHONPATH=src python -m repro_torch.launch.train rl --runtime threaded
  PYTHONPATH=src python -m repro_torch.launch.train rlvr \\
      --producer serve --runtime threaded \\
      --controller "tv_gate:delta=0.05,mode=downweight"

Same flags, defaults and printout as ``repro.launch.train`` for the
parts ported, plus ``--device``.  ``rl`` runs all five algorithms and
all five envs under the ``backward_mixture``, ``forward_n`` and
``threaded`` runtimes.  ``rlvr`` runs the legacy producer
(``ForwardLagGenerator``) or the serve engine (``--producer serve``,
``--forced-lag``, ``--request-deadline``) under ``forward_n`` or
``threaded``; ``--full-width`` trains
``get_config("qwen2.5-0.5b")`` (24 layers, vocab 151936) instead of
``reduced_config``.  Weights are a random init from ``--seed``.  Both
take the ``pass_through``, ``max_lag`` and ``tv_gate`` controllers
(``rlvr`` also ``tv_gate_tokenwise``).

Not ported yet (each exits with a message): the
controllers ``gac``, ``stable_async`` and ``asympo``, and
``--checkpoint-dir``; for ``rlvr`` also ``--fault-plan``,
``--watchdog-restarts`` and ``--guard-checkpoint-dir``, attention-free
archs (``--arch rwkv6-1.6b``: the ``wkv6`` kernel has no backward yet)
and hybrid ones (``--arch hymba-1.5b``: nor has ``ssm_scan``).
As in the JAX launcher, ``--metrics-out`` writes nothing for ``rl``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Optional

_NOT_PORTED = (
    ("--checkpoint-dir", lambda a: a.checkpoint_dir),
)
_NOT_PORTED_RLVR = (
    ("--fault-plan", lambda a: a.fault_plan),
    ("--watchdog-restarts", lambda a: a.watchdog_restarts > 0),
    ("--guard-checkpoint-dir", lambda a: a.guard_checkpoint_dir),
)
_CONTROLLERS_NOT_PORTED = ("gac", "stable_async", "asympo")


def _add_runtime_args(p, *, regimes, default_regime,
                      admissions=("pass_through", "max_lag", "tv_gate"),
                      ) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--runtime", default=default_regime, choices=regimes,
                   help="lag regime driving the actor-learner runtime")
    p.add_argument("--controller", default=None, metavar="SPEC",
                   help="lag controller spec 'name:key=val,...', e.g. "
                        "'tv_gate:delta=0.2,mode=downweight'")
    p.add_argument("--admission", default=None, choices=list(admissions),
                   help="DEPRECATED: use --controller 'name:...'")
    p.add_argument("--max-lag", type=int, default=None,
                   help="DEPRECATED: use --controller 'max_lag:max_lag=N'")
    p.add_argument("--admission-mode", default=None,
                   choices=["drop", "downweight"],
                   help="DEPRECATED: use --controller "
                        "'tv_gate:delta=...,mode=...'")
    p.add_argument("--queue-maxsize", type=int, default=4)
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write an execution trace: .json -> Perfetto, "
                        ".jsonl -> flat event lines")
    p.add_argument("--trace-detail", default="spans",
                   choices=["off", "spans", "full"])
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="append one metrics-registry snapshot as a JSONL "
                        "line at exit")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)

    rl = sub.add_parser("rl", help="simulated-async classic RL (§5.1)")
    rl.add_argument("--env", default="pendulum")
    rl.add_argument("--algorithm", default="vaco",
                    choices=["vaco", "ppo", "ppo_kl", "spo", "impala"])
    rl.add_argument("--buffer-capacity", type=int, default=1)
    rl.add_argument("--n-actors", type=int, default=32)
    rl.add_argument("--rollout-steps", type=int, default=128)
    rl.add_argument("--phases", type=int, default=30)
    rl.add_argument("--seed", type=int, default=0)
    rl.add_argument("--delta", type=float, default=0.2)
    rl.add_argument("--forward-n", type=int, default=4,
                    help="items per frozen policy (forward_n regime)")
    rl.add_argument("--checkpoint-dir", default=None)
    _add_runtime_args(
        rl, regimes=["backward_mixture", "forward_n", "threaded"],
        default_regime="backward_mixture")

    rv = sub.add_parser("rlvr", help="forward-lag RLVR (§5.2)")
    rv.add_argument("--arch", default="qwen2.5-0.5b")
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
    _add_runtime_args(
        rv, regimes=["forward_n", "threaded"], default_regime="forward_n",
        admissions=("pass_through", "max_lag", "tv_gate",
                    "tv_gate_tokenwise"))
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
    checks = _NOT_PORTED + (_NOT_PORTED_RLVR if args.mode == "rlvr" else ())
    for flag, on in checks:
        if on(args):
            raise SystemExit(f"{flag} is not ported to the PyTorch trainer "
                             "yet; use repro.launch.train for it")
    if args.mode == "rlvr":
        from repro_torch.configs import get_config

        cfg = get_config(args.arch)
        if cfg.attn_free:
            raise SystemExit(
                f"train rlvr --arch {args.arch}: training an attention-free "
                "(rwkv) arch needs a backward of the wkv6 kernel, which is "
                "not ported yet; the port serves it (repro_torch.launch."
                "serve --engine static), repro.launch.train trains it")
        if cfg.hybrid_attn_ssm:
            raise SystemExit(
                f"train rlvr --arch {args.arch}: training a hybrid "
                "attention+SSM arch needs a backward of the ssm_scan kernel "
                "(and of flash_attention for the attention to leave the "
                "einsum), which are not ported yet; the port serves it "
                "(repro_torch.launch.serve --engine static), "
                "repro.launch.train trains it")
    name = (args.controller or "").split(":")[0].strip()
    if name in _CONTROLLERS_NOT_PORTED:
        raise SystemExit(f"--controller {name} is not ported to the "
                         "PyTorch trainer yet; use repro.launch.train for it")


def run_rl(args, tracer: Any = None):
    """The classic-RL run ``args`` describe; prints the JAX launcher's
    JSON and returns the ``AsyncRLResult``."""
    from repro_torch.train import (AsyncRLRunConfig, RLHyperparams,
                                   run_async_rl)

    res = run_async_rl(AsyncRLRunConfig(
        env_name=args.env, algorithm=args.algorithm,
        buffer_capacity=args.buffer_capacity,
        n_actors=args.n_actors, rollout_steps=args.rollout_steps,
        total_phases=args.phases, seed=args.seed,
        hp=RLHyperparams(delta=args.delta),
        runtime=args.runtime, forward_n=args.forward_n,
        queue_maxsize=args.queue_maxsize,
        controller=_resolve_controller(args, delta=args.delta),
        tracer=tracer, device=args.device))
    print(json.dumps({
        "runtime": args.runtime,
        "returns": res.returns,
        "final_tv": res.final_tv,
        "runtime_stats": res.runtime_stats,
    }, indent=1))
    return res


def build_trainer(args, tracer: Any = None):
    """The RLVR trainer ``args`` describe (model, dataset,
    hyperparameters)."""
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
        producer=args.producer, forced_lag=args.forced_lag,
        engine_max_batch=args.engine_max_batch,
        request_deadline_s=args.request_deadline,
        queue_maxsize=args.queue_maxsize,
        finiteness_guard=not args.no_finiteness_guard)
    if args.max_new_tokens is not None:
        hp_kwargs["max_new_tokens"] = args.max_new_tokens
    return RLVRTrainer(build(cfg), ds, RLVRHyperparams(**hp_kwargs),
                       seed=args.seed, tracer=tracer, device=args.device)


def run(args, tracer: Any = None):
    """RLVR warmup, train and print, as the JAX launcher does; returns
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
    if args.mode == "rl":
        run_rl(args, tracer if args.trace else None)
    else:
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
    if args.mode == "rlvr" and args.metrics_out:
        trainer.metrics.export_jsonl(args.metrics_out)
        print(f"metrics: snapshot -> {args.metrics_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
