"""Fig. 11 reproduction on the port (torch runner of
``benchmarks/fig11_tv_tracking.py``): final-policy TV divergence
tracking.

Measures the TV divergence between the end-of-phase policy and its
behavior data for VACO vs PPO(-KL) across environments and
asynchronicity levels.  Paper claim: VACO maintains the SAME TV level
(the delta/2 constraint) everywhere, predictable from the threshold,
while PPO's achieved TV varies and is not predictable from the clip
ratio.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.train.runner_rl import AsyncRLRunConfig, run_async_rl
from repro_torch.train.trainer_rl import RLHyperparams


def run(envs: List[str], capacities: List[int], seeds: List[int],
        phases: int, delta: float, *, device: Any = None,
        params: Optional[Callable[[str, int], Any]] = None,
        make_draws: Optional[Callable] = None) -> Dict[str, Dict]:
    report: Dict[str, Dict] = {}
    for alg in ("vaco", "ppo", "ppo_kl"):
        report[alg] = {}
        for cap in capacities:
            tvs = []
            for env in envs:
                for seed in seeds:
                    res = run_async_rl(AsyncRLRunConfig(
                        env_name=env, algorithm=alg, buffer_capacity=cap,
                        total_phases=phases, seed=seed,
                        hp=RLHyperparams(delta=delta), device=device),
                        params=None if params is None else params(env, seed),
                        make_draws=make_draws)
                    tvs.append(res.final_tv)
            report[alg][f"K={cap}"] = {
                "mean_tv": round(float(np.mean(tvs)), 4),
                "std_tv": round(float(np.std(tvs)), 4),
            }
            print(f"{alg:8s} K={cap:3d} final TV = "
                  f"{np.mean(tvs):.4f} +- {np.std(tvs):.4f} "
                  f"(VACO target delta/2 = {delta/2:.3f})")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--envs", nargs="+",
                    default=["pendulum", "pointmass", "reacher"])
    ap.add_argument("--capacities", nargs="+", type=int, default=[1, 8])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--phases", type=int, default=12)
    ap.add_argument("--delta", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    report = run(args.envs, args.capacities, args.seeds, args.phases,
                 args.delta, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
