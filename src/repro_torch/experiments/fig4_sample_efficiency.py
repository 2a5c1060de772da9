"""Fig. 4 reproduction on the port (torch runner of
``benchmarks/fig4_sample_efficiency.py``): IQM learning curves +
area-under-curve.

Tracks the normalized-return IQM across training phases for each
algorithm x asynchronicity level, plus the AUC sample-efficiency summary
(Fig. 4 bottom-right).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.metrics.aggregate import iqm
from repro_torch.train.runner_rl import AsyncRLRunConfig, run_async_rl

DEFAULT_ENVS = ["pendulum", "cartpole_swingup", "acrobot"]
DEFAULT_ALGS = ["vaco", "ppo", "spo", "impala"]


def run_curves(
    envs: List[str], algorithms: List[str], capacity: int,
    seeds: List[int], phases: int, *,
    params: Optional[Callable[[str, int], Any]] = None,
    make_draws: Optional[Callable] = None, **kw,
) -> Dict[str, np.ndarray]:
    """Returns {alg: [envs, seeds, phases] return curves}; ``kw`` reach
    every ``AsyncRLRunConfig`` (``device`` among them)."""
    out = {}
    for alg in algorithms:
        curves = np.zeros((len(envs), len(seeds), phases))
        for i, env in enumerate(envs):
            for j, seed in enumerate(seeds):
                res = run_async_rl(AsyncRLRunConfig(
                    env_name=env, algorithm=alg, buffer_capacity=capacity,
                    total_phases=phases, seed=seed, **kw),
                    params=None if params is None else params(env, seed),
                    make_draws=make_draws)
                curves[i, j] = np.asarray(res.returns)
        out[alg] = curves
    return out


def report_curves(curves: Dict[str, np.ndarray], n_envs: int,
                  phases: int, capacity: int) -> Dict:
    """The JSON report: per algorithm its IQM curve and AUC, normalized
    per env across algorithms."""
    flat = {a: c.reshape(n_envs, -1) for a, c in curves.items()}
    lo = np.min(np.stack([v for v in flat.values()]), axis=(0, 2))
    hi = np.max(np.stack([v for v in flat.values()]), axis=(0, 2))
    rng = np.where(hi - lo < 1e-9, 1.0, hi - lo)

    print(f"== IQM learning curves (K={capacity}) ==")
    report = {}
    for alg, c in curves.items():
        normed = (c - lo[:, None, None]) / rng[:, None, None]
        curve_iqm = [iqm(normed[:, :, t]) for t in range(phases)]
        auc_val = float(np.mean(curve_iqm))
        report[alg] = {"iqm_curve": [round(x, 4) for x in curve_iqm],
                       "auc": round(auc_val, 4)}
        spark = "".join(
            " .:-=+*#%@"[min(9, int(v * 10))] for v in curve_iqm)
        print(f"  {alg:8s} AUC={auc_val:.3f}  |{spark}|")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--envs", nargs="+", default=DEFAULT_ENVS)
    ap.add_argument("--algorithms", nargs="+", default=DEFAULT_ALGS)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--phases", type=int, default=16)
    ap.add_argument("--n-actors", type=int, default=16)
    ap.add_argument("--rollout-steps", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    curves = run_curves(args.envs, args.algorithms, args.capacity,
                        args.seeds, args.phases,
                        n_actors=args.n_actors,
                        rollout_steps=args.rollout_steps,
                        device=args.device)
    # normalize per env across algorithms using the whole curves' spread.
    report = report_curves(curves, len(args.envs), args.phases,
                           args.capacity)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
