"""Fig. 7/8 reproduction on the port (torch runner of
``benchmarks/ablation_delta.py``): ablation on the TV threshold delta.

Runs VACO across delta values under a fixed degree of asynchronicity and
reports final normalized aggregates.  Paper claim: VACO is robust to
aggressive (small) delta values; constrained optimization avoids the
policy collapse that aggressive clipping induces in PPO.
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


def run(deltas: List[float], envs: List[str], capacity: int,
        seeds: List[int], phases: int, *, device: Any = None,
        params: Optional[Callable[[str, int], Any]] = None,
        make_draws: Optional[Callable] = None) -> Dict[str, Dict]:
    report: Dict[str, Dict] = {}
    all_scores = {}
    for delta in deltas:
        scores = np.zeros((len(envs), len(seeds)))
        tvs = []
        for i, env in enumerate(envs):
            for j, seed in enumerate(seeds):
                res = run_async_rl(AsyncRLRunConfig(
                    env_name=env, algorithm="vaco",
                    buffer_capacity=capacity, total_phases=phases,
                    seed=seed, hp=RLHyperparams(delta=delta),
                    device=device),
                    params=None if params is None else params(env, seed),
                    make_draws=make_draws)
                scores[i, j] = float(np.mean(res.returns[-3:]))
                tvs.append(res.final_tv)
        all_scores[delta] = scores
        report[f"delta={delta}"] = {
            "mean_final_tv": round(float(np.mean(tvs)), 4),
            "raw_scores": scores.tolist(),
        }
    # min-max normalize across deltas, report IQM per delta.
    stacked = np.stack(list(all_scores.values()))
    lo, hi = stacked.min(), stacked.max()
    rng = (hi - lo) or 1.0
    for delta in deltas:
        normed = (all_scores[delta] - lo) / rng
        report[f"delta={delta}"]["iqm"] = round(iqm(normed), 4)
        print(f"delta={delta:5.2f} IQM={report[f'delta={delta}']['iqm']:.3f}"
              f" final_TV={report[f'delta={delta}']['mean_final_tv']:.4f}"
              f" (constraint delta/2={delta/2:.3f})")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--deltas", nargs="+", type=float,
                    default=[0.05, 0.1, 0.2, 0.4])
    ap.add_argument("--envs", nargs="+",
                    default=["pendulum", "pointmass"])
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--phases", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    report = run(args.deltas, args.envs, args.capacity, args.seeds,
                 args.phases, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
