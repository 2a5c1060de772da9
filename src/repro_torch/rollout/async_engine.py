"""The phase-locked producers (port of ``repro.rollout.async_engine``):
``SimulatedAsyncActors``, the §5.1 backward-lag mixture, and the RLVR
producer's ``RLVRMinibatch`` and ``ForwardLagGenerator``.

``SimulatedAsyncActors`` is the legacy surface over the runtime: a
``PolicyStore`` whose ring is the old ``PolicyBuffer`` and the
``MixtureRolloutProducer`` the ``backward_mixture`` regime drives.

``ForwardLagGenerator.generate_minibatch`` is the producer callable the
lag regimes drive: sample prompts, generate grouped completions with the
static ``generate``, verify them.  The Gumbel noise of each call comes
from one ``torch.Generator`` chain seeded with ``seed``; ``_noise`` is the
hook a test overrides to replay the JAX key chain.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.mathgen import verify
from repro_torch.envs.base import Env
from repro_torch.rollout.env_rollout import Draws, RolloutBatch
from repro_torch.rollout.sampler import (GenerationResult, NoiseFn, generate,
                                         gumbel_noise)
from repro_torch.runtime.policy_store import PolicyStore
from repro_torch.runtime.regimes import MixtureRolloutProducer
from repro_torch.serve.engine import resolve_device


class SimulatedAsyncActors:
    """Policy-ring actors over batched environments (adapter)."""

    def __init__(
        self,
        env: Env,
        policy_apply: Callable,
        init_params: Any,
        *,
        n_actors: int,
        buffer_capacity: int,
        rollout_steps: int,
        seed: int = 0,
        device: Any = None,
        draws: Optional[Draws] = None,
    ) -> None:
        self.env = env
        self.n_actors = n_actors
        self.rollout_steps = rollout_steps
        self.store = PolicyStore(init_params, buffer_capacity)
        self._producer = MixtureRolloutProducer(
            env, policy_apply, n_actors=n_actors,
            rollout_steps=rollout_steps, seed=seed, device=device,
            draws=draws)

    @property
    def buffer(self):
        """The underlying policy ring (legacy attribute)."""
        return self.store.buffer

    def push_policy(self, params: Any) -> int:
        """Learner publishes a new policy snapshot (end of train phase)."""
        return self.store.publish(params)

    def collect(self) -> Tuple[RolloutBatch, torch.Tensor]:
        """One collection phase: every actor re-samples a stale policy and
        rolls ``rollout_steps`` steps.  Returns (batch, sampled slots)."""
        return self._producer(self.store.buffer)


class RLVRMinibatch(NamedTuple):
    """One generated+verified minibatch, the TrajectoryQueue payload.
    ``versions`` is the per-token producing-policy version ``[B, T]``."""

    gen: GenerationResult
    rewards: torch.Tensor       # [B] binary verifier rewards, float32
    answers: List[str]
    versions: Optional[np.ndarray] = None


class ForwardLagGenerator:
    """Serve-side producer for RLVR (§5.2): generation + verification."""

    def __init__(
        self,
        bundle,
        dataset,
        *,
        prompts_per_minibatch: int,
        completions_per_prompt: int,
        max_new_tokens: int,
        temperature: float = 1.0,
        seed: int = 0,
        version_fn: Optional[Callable[[], int]] = None,
        device: Any = None,
        eval_seed: Optional[int] = None,
    ) -> None:
        self.bundle = bundle
        self.dataset = dataset
        self.prompts_per_minibatch = prompts_per_minibatch
        self.group_size = completions_per_prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.version_fn = version_fn
        self.device = resolve_device(device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        # A generator serves one thread: under the threaded regime the
        # producer thread generates and the learner evaluates, so eval
        # then draws from a chain of its own (``eval_seed``).
        self._eval_generator = (
            None if eval_seed is None else
            torch.Generator(device=self.device).manual_seed(eval_seed))

    def _noise(self) -> NoiseFn:
        """The noise source of one generate call (one per call, as the
        JAX generator splits one key per call)."""
        return lambda t, shape: gumbel_noise(shape, self._generator,
                                             self.device)

    def _eval_noise(self) -> NoiseFn:
        if self._eval_generator is None:
            return self._noise()
        return lambda t, shape: gumbel_noise(shape, self._eval_generator,
                                             self.device)

    def _generate(self, params: Any, prompts: np.ndarray,
                  temperature: float, noise: NoiseFn) -> GenerationResult:
        return generate(
            self.bundle, params,
            torch.as_tensor(prompts, device=self.device),
            max_new_tokens=self.max_new_tokens, temperature=temperature,
            noise=noise)

    def generate_minibatch(self, params: Any) -> RLVRMinibatch:
        """Sample prompts, generate grouped completions, verify rewards."""
        version = (int(self.version_fn())
                   if self.version_fn is not None else None)
        tok = self.dataset.tok
        toks_np, _, answers = self.dataset.sample_batch(
            self.prompts_per_minibatch)
        # Group: repeat each prompt G times (GRPO groups contiguous).
        toks_np = np.repeat(toks_np, self.group_size, axis=0)
        answers = [a for a in answers for _ in range(self.group_size)]
        gen = self._generate(params, toks_np, self.temperature,
                             self._noise())
        comp_np = gen.completion.cpu().numpy()
        rewards = torch.tensor(
            [verify(tok.decode(row), ans)
             for row, ans in zip(comp_np, answers)],
            dtype=torch.float32, device=self.device)
        versions = None
        if version is not None:
            versions = np.full(comp_np.shape, version, np.int64)
        return RLVRMinibatch(gen=gen, rewards=rewards, answers=answers,
                             versions=versions)

    def eval_accuracy(self, params: Any, n: Optional[int] = 256) -> float:
        """Greedy-decode exact-match accuracy on the held-out set
        (temperature 1e-4, as the reference decodes it)."""
        toks_np, _, answers = self.dataset.eval_batch(n)
        gen = self._generate(params, toks_np, 1e-4, self._eval_noise())
        comp = gen.completion.cpu().numpy()
        hits = [verify(self.dataset.tok.decode(row), ans)
                for row, ans in zip(comp, answers)]
        return float(np.mean(hits))
