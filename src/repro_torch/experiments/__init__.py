"""The paper's figure harnesses on the port (torch runners of
``benchmarks/fig3_backward_lag.py``, ``fig4_sample_efficiency.py``,
``fig11_tv_tracking.py``, ``fig5_rlvr_forward_lag.py`` and the three
``ablation_*.py``, under the same file names).

Each keeps its original's flags, defaults and JSON report and adds
``--device`` (``cuda`` by default; ``cpu`` on request):

  PYTHONPATH=src python -m repro_torch.experiments.fig3_backward_lag \\
      --envs pendulum --algorithms vaco ppo --capacities 1 4 --seeds 0 \\
      --phases 3 --n-actors 500 --rollout-steps 1000 --out fig3.json

The runners' functions take the seams ``run_async_rl`` has (``params``,
``make_draws``; None: the seeded init and draws), so a test can replay
the JAX key chain through them.
"""
