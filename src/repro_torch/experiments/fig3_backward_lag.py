"""Fig. 3 reproduction on the port (torch runner of
``benchmarks/fig3_backward_lag.py``): backward policy lag vs aggregate
performance.

Runs the simulated-async grid (envs x algorithms x buffer capacities x
seeds), min-max normalizes per task across algorithms, and reports
Median / IQM / Mean / Optimality-Gap with stratified-bootstrap 95% CIs,
the paper's evaluation protocol.

Paper claim validated: VACO's aggregates degrade *less* than
PPO/PPO-KL/SPO as the policy-buffer capacity (degree of asynchronicity)
grows.

Scale knobs (paper -> defaults): 500 envs -> 16, 1000-step rollouts ->
96, 100M steps -> ~50k per run, 10 seeds -> 3 (``--n-actors 500
--rollout-steps 1000`` is the paper's collection).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.metrics.aggregate import aggregate_metrics
from repro_torch.train.runner_rl import run_grid

DEFAULT_ENVS = ["pendulum", "cartpole_swingup", "acrobot", "pointmass",
                "reacher"]
DEFAULT_ALGS = ["vaco", "ppo", "ppo_kl", "spo", "impala"]


def run(
    envs: List[str],
    algorithms: List[str],
    capacities: List[int],
    seeds: List[int],
    n_actors: int = 16,
    rollout_steps: int = 96,
    phases: int = 20,
    *,
    device: Any = None,
    params: Optional[Callable[[str, int], Any]] = None,
    make_draws: Optional[Callable] = None,
    **run_kwargs: Any,
) -> Dict:
    """The report; ``run_kwargs`` reach every ``AsyncRLRunConfig``."""
    t0 = time.time()
    grid = run_grid(
        envs, algorithms, capacities, seeds,
        n_actors=n_actors, rollout_steps=rollout_steps,
        total_phases=phases, device=device, params=params,
        make_draws=make_draws, **run_kwargs,
    )
    results = {}
    for cap in capacities:
        scores_by_alg = {alg: grid[alg][cap] for alg in algorithms}
        agg = aggregate_metrics(scores_by_alg, n_boot=500)
        results[f"K={cap}"] = {
            alg: {m: [round(x, 4) for x in v] for m, v in per.items()}
            for alg, per in agg.items()
        }
    results["_raw"] = {
        alg: {str(cap): grid[alg][cap].tolist() for cap in capacities}
        for alg in algorithms
    }
    results["_seconds"] = round(time.time() - t0, 1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--envs", nargs="+", default=DEFAULT_ENVS)
    ap.add_argument("--algorithms", nargs="+", default=DEFAULT_ALGS)
    ap.add_argument("--capacities", nargs="+", type=int,
                    default=[1, 4, 16])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--phases", type=int, default=20)
    ap.add_argument("--n-actors", type=int, default=16)
    ap.add_argument("--rollout-steps", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    res = run(args.envs, args.algorithms, args.capacities, args.seeds,
              n_actors=args.n_actors, rollout_steps=args.rollout_steps,
              phases=args.phases, device=args.device)

    for cap_key, per_alg in res.items():
        if cap_key.startswith("_"):
            continue
        print(f"\n== {cap_key} (normalized aggregates, 95% CI) ==")
        for alg, metrics in per_alg.items():
            iqm = metrics["iqm"]
            gap = metrics["optimality_gap"]
            print(f"  {alg:8s} IQM={iqm[0]:.3f} [{iqm[1]:.3f},{iqm[2]:.3f}]"
                  f"  OptGap={gap[0]:.3f} [{gap[1]:.3f},{gap[2]:.3f}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
