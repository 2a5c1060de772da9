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

  # the threaded serve producer under faults: a crash the watchdog
  # restarts, a stall past the request deadline, a quarantined publish,
  # a poisoned learner step rolled back; the params saved at the end
  PYTHONPATH=src python -m repro_torch.launch.train rlvr \\
      --producer serve --runtime threaded --controller gac \\
      --fault-plan "producer_crash:at_step=2;nan_publish:at_publish=4" \\
      --watchdog-restarts 2 --request-deadline 3 --checkpoint-dir ckpt

Same flags, defaults and printout as ``repro.launch.train`` for the
parts ported, plus ``--device``.  ``rl`` runs all five algorithms and
all five envs under the ``backward_mixture``, ``forward_n`` and
``threaded`` runtimes.  ``rlvr`` runs the legacy producer
(``ForwardLagGenerator``) or the serve engine (``--producer serve``,
``--forced-lag``, ``--request-deadline``) under ``forward_n`` or
``threaded``; ``--full-width`` trains
``get_config(--arch)`` (qwen2.5-0.5b: 24 layers, vocab 151936) instead
of ``reduced_config``.  ``--arch hymba-1.5b`` (hybrid attention+SSM:
32 layers, d 1600) and ``--arch rwkv6-1.6b`` (attention-free: 24
layers, d 2048) train through the legacy producer; on the card hymba's
attention and SSM recurrence run forward and backward kernels
(``flash_attention``/``flash_attention_bwd``, ``ssm_scan``/
``ssm_scan_bwd``) and rwkv6's time-mix ``wkv6``/``wkv6_bwd``, and
``--producer serve`` refuses both with the reference engine's reason
(``models.transformer.paged_arch_unsupported``: unpaged or recurrent
state).  Weights are a random init from ``--seed``.  Both
take every controller of ``runtime.controllers`` (``rl`` builds the
queue's; the learner hooks of ``gac``, ``stable_async`` and ``asympo``
run in ``rlvr``).  ``rlvr`` takes the resilience flags
(``--fault-plan``, ``--fault-seed``, ``--watchdog-restarts``,
``--watchdog-backoff-ms``, ``--guard-checkpoint-dir``) and saves the
trained params under ``--checkpoint-dir``; as in the JAX launcher,
``rl`` accepts ``--checkpoint-dir`` and writes nothing, and
``--metrics-out`` writes nothing for ``rl``.  SIGINT/SIGTERM stop the
producer and flush the trace and metrics before exiting.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from typing import Any, List, Optional

def _add_runtime_args(p, *, regimes, default_regime,
                      admissions=("pass_through", "max_lag", "tv_gate"),
                      ) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--runtime", default=default_regime, choices=regimes,
                   help="lag regime driving the actor-learner runtime")
    p.add_argument("--controller", default=None, metavar="SPEC",
                   help="lag controller spec 'name:key=val,...', e.g. "
                        "'tv_gate:delta=0.2,mode=downweight', "
                        "'stable_async:c_max=2.0'; see "
                        "repro_torch.runtime.available_controllers()")
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
                        "line at exit (flushed early on SIGINT/SIGTERM)")


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
    rv.add_argument("--fault-plan", default="", metavar="PLAN",
                    help="fault-injection plan, ';'-joined "
                         "'kind:key=val,...' chunks, e.g. "
                         "'producer_crash:at_step=4;"
                         "nan_publish:at_publish=7'")
    rv.add_argument("--fault-seed", type=int, default=0,
                    help="seed for probabilistic faults + stall jitter")
    rv.add_argument("--watchdog-restarts", type=int, default=0,
                    help="supervise threaded producers: restart a "
                         "crashed producer up to N times with seeded "
                         "exponential backoff (0 = crash-fast)")
    rv.add_argument("--watchdog-backoff-ms", type=float, default=50.0,
                    help="watchdog restart backoff base (doubles per "
                         "attempt, jittered)")
    rv.add_argument("--request-deadline", type=float, default=None,
                    metavar="SECONDS")
    rv.add_argument("--no-finiteness-guard", action="store_true",
                    help="disable the NaN/Inf firewall (non-finite "
                         "publishes quarantined, non-finite learner "
                         "steps skipped + rolled back)")
    rv.add_argument("--guard-checkpoint-dir", default=None,
                    help="finiteness guard restores from the newest "
                         "checkpoint here (also written after every "
                         "finite step) instead of the in-memory copy")
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
    if args.mode != "rlvr":
        return
    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.producer == "serve":
        from repro_torch.models.transformer import paged_arch_unsupported

        reason = paged_arch_unsupported(cfg)
        if reason is not None:
            # The engine (both packages') refuses it: the same words.
            raise SystemExit(f"train rlvr --arch {args.arch} --producer "
                             f"serve: {cfg.name}: {reason}")


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
        fault_plan=args.fault_plan, fault_seed=args.fault_seed,
        watchdog_restarts=args.watchdog_restarts,
        watchdog_backoff_ms=args.watchdog_backoff_ms,
        finiteness_guard=not args.no_finiteness_guard,
        guard_checkpoint_dir=args.guard_checkpoint_dir)
    if args.max_new_tokens is not None:
        hp_kwargs["max_new_tokens"] = args.max_new_tokens
    return RLVRTrainer(build(cfg), ds, RLVRHyperparams(**hp_kwargs),
                       seed=args.seed, tracer=tracer, device=args.device)


def run(args, tracer: Any = None, flush_state: Optional[dict] = None):
    """RLVR warmup, train and print, as the JAX launcher does; returns
    ``(trainer, result, warmup_loss)``.  ``flush_state["trainer"]`` is set
    as soon as the trainer exists (for the signal flush)."""
    trainer = build_trainer(args, tracer)
    if flush_state is not None:
        flush_state["trainer"] = trainer
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


def save_params(args, trainer) -> Optional[str]:
    """``--checkpoint-dir``: the trained params as ``<phases>.ckpt``, as
    the JAX launcher saves them; returns the path (None without the
    flag)."""
    if not args.checkpoint_dir:
        return None
    from repro_torch.checkpoint import save_checkpoint

    path = save_checkpoint(args.checkpoint_dir, args.phases,
                           trainer.state.params,
                           meta={"arch": trainer.bundle.cfg.name})
    print(f"checkpoint: {path}")
    return path


def main(argv: Optional[List[str]] = None) -> int:
    # Full-width hymba training holds ~71 GiB of an 80 GB card at its
    # AdamW step; expandable segments keep the caching allocator's split
    # blocks from stranding the rest.  Read when CUDA starts.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

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

    # SIGINT/SIGTERM stop the producer and flush the trace and metrics
    # before exiting: an interrupted run still leaves its telemetry.
    flush_state = {"trainer": None}

    def _flush(signum: int) -> None:
        trainer = flush_state.get("trainer")
        if trainer is not None:
            try:
                trainer.close()
            except Exception:
                pass
            if args.metrics_out:
                trainer.metrics.export_jsonl(args.metrics_out, signal=signum)
                print(f"metrics: flushed -> {args.metrics_out}")
        _export_trace()

    previous = install_flush_handlers(_flush)
    try:
        if args.mode == "rl":
            run_rl(args, tracer if args.trace else None)
            _export_trace()
            return 0
        trainer, _, _ = run(args, tracer, flush_state)
        _export_trace()
        if args.metrics_out:
            trainer.metrics.export_jsonl(args.metrics_out)
            print(f"metrics: snapshot -> {args.metrics_out}")
        save_params(args, trainer)
        return 0
    finally:
        # The handlers close over this run: put back what was there.
        for sig, handler in previous.items():
            signal.signal(sig, handler)


if __name__ == "__main__":
    sys.exit(main())
