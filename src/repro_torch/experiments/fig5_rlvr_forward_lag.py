"""Fig. 5 reproduction on the port (torch runner of
``benchmarks/fig5_rlvr_forward_lag.py``): RLVR forward policy lag,
GRPO (PPO-clip) vs GRPO+VACO.

Protocol (§5.2): warm-start a base model on synthetic verifiable math,
then for each N in --minibatches run the generate-N/train-N loop and
record (top) eval exact-match accuracy vs N, and (bottom) the PPO clip
fraction vs the VACO filter rate per staleness level.

Paper claims validated:
  * eval accuracy degrades from N=1 as forward lag increases (both),
    VACO retaining more;
  * PPO clips constantly and proportionally to lag; VACO filters rarely
    at low lag and selectively-but-heavily when triggered.

The model is ``reduced_config(arch)`` without its value head, as in the
reference; ``--full-width`` trains ``get_config(arch)`` instead (for
qwen2.5-0.5b: 24 layers, d 896, vocab 151936), as ``launch.train``'s
flag does.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.mathgen import MathTaskDataset
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.models.registry import build
from repro_torch.train.trainer_rlvr import RLVRHyperparams, RLVRTrainer


def run_one(arch: str, algorithm: str, n_minibatches: int, *,
            phases: int, seed: int, level: int,
            warmup_steps: int, device: Any = None,
            full_width: bool = False, params: Any = None) -> Dict:
    """One (algorithm, N, seed) cell; ``params`` (a tree) replaces the
    seeded init."""
    tok = get_tokenizer()
    cfg = (get_config(arch) if full_width else
           reduced_config(arch, vocab=tok.vocab_size).replace(
               value_head=False))
    bundle = build(cfg)
    ds = MathTaskDataset(prompt_len=24, level=level, seed=seed)
    hp = RLVRHyperparams(
        algorithm=algorithm, n_minibatches=n_minibatches,
        prompts_per_minibatch=8, completions_per_prompt=4,
        max_new_tokens=6, warmup_steps=warmup_steps, lr=3e-5,
    )
    tr = RLVRTrainer(bundle, ds, hp, seed=seed, params=params,
                     device=device)
    tr.warmup()
    acc0 = tr.evaluate(128)
    res = tr.train(phases, eval_every=max(phases, 1))
    # filter/clip rate by staleness
    by_stale: Dict[int, List[float]] = {}
    tv_by_stale: Dict[int, List[float]] = {}
    for log in res.phase_logs:
        by_stale.setdefault(log.staleness, []).append(log.frac_filtered)
        tv_by_stale.setdefault(log.staleness, []).append(log.tv)
    return {
        "acc_after_warmup": acc0,
        "acc_final": res.eval_accuracy[-1] if res.eval_accuracy else None,
        "mean_reward_last": float(np.mean(
            [l.mean_reward for l in res.phase_logs[-n_minibatches:]])),
        "filter_rate_by_staleness": {
            str(k): round(float(np.mean(v)), 4)
            for k, v in sorted(by_stale.items())},
        "tv_by_staleness": {
            str(k): round(float(np.mean(v)), 4)
            for k, v in sorted(tv_by_stale.items())},
    }


def run(arch: str, minibatches: List[int], seeds: List[int], *,
        phases: int, level: int, warmup_steps: int, device: Any = None,
        full_width: bool = False) -> Dict[str, Dict]:
    report: Dict[str, Dict] = {}
    for alg in ("grpo", "grpo_vaco"):
        report[alg] = {}
        for n in minibatches:
            accs = []
            per_seed = []
            for seed in seeds:
                r = run_one(arch, alg, n, phases=phases, seed=seed,
                            level=level, warmup_steps=warmup_steps,
                            device=device, full_width=full_width)
                per_seed.append(r)
                accs.append(r["acc_final"])
            report[alg][f"N={n}"] = {
                "acc_final_mean": round(float(np.mean(accs)), 4),
                "per_seed": per_seed,
            }
            print(f"{alg:10s} N={n:2d} acc={np.mean(accs):.3f} "
                  f"filter/clip={per_seed[0]['filter_rate_by_staleness']}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-0.5b")
    ap.add_argument("--full-width", action="store_true",
                    help="train the full config (get_config) instead of "
                         "the reduced one")
    ap.add_argument("--minibatches", nargs="+", type=int,
                    default=[1, 2, 4, 8])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--phases", type=int, default=6)
    ap.add_argument("--level", type=int, default=0)
    ap.add_argument("--warmup-steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    report = run(args.arch, args.minibatches, args.seeds,
                 phases=args.phases, level=args.level,
                 warmup_steps=args.warmup_steps, device=args.device,
                 full_width=args.full_width)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
