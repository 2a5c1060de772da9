"""Algorithm core of the learners (port of ``repro.core``): the TV
filter, the VACO/PPO/SPO/IMPALA and GRPO losses, V-trace, GAE, the
diagonal Gaussian and the policy snapshot ring."""
