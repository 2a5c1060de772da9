"""Fig. 9/10 reproduction on the port (torch runner of
``benchmarks/ablation_rho.py``): ablation on the V-trace rho_bar
threshold.

rho_bar controls the fixed point of the realignment target (App. B.5 /
Espeholt et al. 2018).  Paper finding (confirming IMPALA): rho_bar = 1
outperforms larger values.
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


def run(rhos: List[float], envs: List[str], capacity: int,
        seeds: List[int], phases: int, *, device: Any = None,
        params: Optional[Callable[[str, int], Any]] = None,
        make_draws: Optional[Callable] = None) -> Dict[str, Dict]:
    report: Dict[str, Dict] = {}
    all_scores = {}
    for rho in rhos:
        scores = np.zeros((len(envs), len(seeds)))
        for i, env in enumerate(envs):
            for j, seed in enumerate(seeds):
                res = run_async_rl(AsyncRLRunConfig(
                    env_name=env, algorithm="vaco",
                    buffer_capacity=capacity,
                    total_phases=phases, seed=seed,
                    hp=RLHyperparams(rho_bar=rho, c_bar=min(rho, 1.0)),
                    device=device),
                    params=None if params is None else params(env, seed),
                    make_draws=make_draws)
                scores[i, j] = float(np.mean(res.returns[-3:]))
        all_scores[rho] = scores
        report[f"rho={rho}"] = {"raw_scores": scores.tolist()}
    stacked = np.stack(list(all_scores.values()))
    lo, hi = stacked.min(), stacked.max()
    rng = (hi - lo) or 1.0
    for rho in rhos:
        normed = (all_scores[rho] - lo) / rng
        report[f"rho={rho}"]["iqm"] = round(iqm(normed), 4)
        print(f"rho_bar={rho:5.1f} IQM={report[f'rho={rho}']['iqm']:.3f}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rhos", nargs="+", type=float,
                    default=[1.0, 2.0, 8.0])
    ap.add_argument("--envs", nargs="+",
                    default=["pendulum", "pointmass"])
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--phases", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    report = run(args.rhos, args.envs, args.capacity, args.seeds,
                 args.phases, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
