"""Algorithm core of the learner (port of the parts of ``repro.core`` the
RLVR learner runs): the TV filter, the GRPO/VACO losses and the policy
snapshot ring."""
