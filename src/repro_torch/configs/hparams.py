# Copied from src/repro/configs/hparams.py; keep the two in step.
"""Paper hyper-parameter tables, as code (Table 1 and Table 2).

These are the *paper-faithful* values over the port's hyperparameter
classes; the figure runners (``repro_torch.experiments``) override only
the scale knobs (num envs, steps, episodes).
"""
from repro_torch.train.trainer_rl import RLHyperparams
from repro_torch.train.trainer_rlvr import RLVRHyperparams

# Table 1 — simulated-async MuJoCo setup (CleanRL defaults).
TABLE1_RL = RLHyperparams(
    algorithm="vaco",
    delta=0.2,                 # Clip Ratio / TV Threshold
    lr=3e-4,                   # + linear annealing (handled by trainer)
    gamma=0.99,
    num_minibatches=32,
    num_epochs=10,
    max_grad_norm=0.5,
    rho_bar=1.0,
    c_bar=1.0,
)
TABLE1_SCALE = dict(num_envs=500, num_steps=1000)  # paper-scale collection

# Table 2 — GSM8k RLVR setup.
TABLE2_RLVR = RLVRHyperparams(
    algorithm="grpo_vaco",
    clip_low=0.2,              # PPO-Clip Lower Ratio
    clip_high=0.272,           # PPO-Clip Higher Ratio (DAPO)
    delta=0.05,                # TV Threshold
    lr=1e-6,                   # paper LR on the 0.5B model
    prompts_per_minibatch=32,
    completions_per_prompt=8,
    max_new_tokens=512,        # Completion Length
    temperature=1.0,
)
TABLE2_SCALE = dict(total_episodes=65536, num_steps=256, prompt_length=512)
