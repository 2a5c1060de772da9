"""Fig. 12 reproduction on the port (torch runner of
``benchmarks/ablation_realignment.py``): VACO with vs without advantage
realignment.

"Without realignment" replaces the V-trace advantage (w.r.t. pi_T) by
plain GAE on the behavioral data while keeping the TV filter, isolating
the contribution of the realignment term.  Paper finding: realignment
offers better robustness to off-policy data on average.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.metrics.aggregate import iqm
from repro_torch.train.runner_rl import AsyncRLRunConfig, run_async_rl
from repro_torch.train.trainer_rl import RLHyperparams

VARIANTS = {
    "vaco(realigned)": {"realign": True},
    "vaco(no-realign)": {"realign": False},
}


def run(envs: List[str], capacities: List[int], seeds: List[int],
        phases: int, *, device: Any = None,
        params: Optional[Callable[[str, int], Any]] = None,
        make_draws: Optional[Callable] = None) -> Dict[str, Dict]:
    report: Dict[str, Dict] = {}
    all_scores = {}
    for name, opts in VARIANTS.items():
        per_cap = {}
        for cap in capacities:
            scores = np.zeros((len(envs), len(seeds)))
            for i, env in enumerate(envs):
                for j, seed in enumerate(seeds):
                    hp = RLHyperparams(realign=opts["realign"])
                    res = run_async_rl(AsyncRLRunConfig(
                        env_name=env, algorithm="vaco",
                        buffer_capacity=cap, total_phases=phases,
                        seed=seed, hp=hp, device=device),
                        params=(None if params is None
                                else params(env, seed)),
                        make_draws=make_draws)
                    scores[i, j] = float(np.mean(res.returns[-3:]))
            per_cap[cap] = scores
        all_scores[name] = per_cap

    for cap in capacities:
        stacked = np.stack([all_scores[n][cap] for n in VARIANTS])
        lo, hi = stacked.min(), stacked.max()
        rng = (hi - lo) or 1.0
        print(f"== K={cap} ==")
        report[f"K={cap}"] = {}
        for name in VARIANTS:
            normed = (all_scores[name][cap] - lo) / rng
            val = iqm(normed)
            report[f"K={cap}"][name] = round(val, 4)
            print(f"  {name:18s} IQM={val:.3f}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--envs", nargs="+",
                    default=["pendulum", "pointmass", "reacher"])
    ap.add_argument("--capacities", nargs="+", type=int, default=[4, 16])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--phases", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    report = run(args.envs, args.capacities, args.seeds, args.phases,
                 device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
