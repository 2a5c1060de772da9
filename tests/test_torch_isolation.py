"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the ``repro`` package, its entry points
refuse to fall back to the CPU silently, and its CUDA-only tests skip
cleanly on a host without a card."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods
    assert "repro_torch.train.trainer_rlvr" in mods
    assert "repro_torch.launch.train" in mods
    assert "repro_torch.train.trainer_rl" in mods
    assert "repro_torch.train.runner_rl" in mods
    assert "repro_torch.envs.classic" in mods
    assert "repro_torch.models.rwkv6" in mods
    assert "repro_torch.kernels.wkv6" in mods
    assert "repro_torch.models.ssm" in mods
    assert "repro_torch.kernels.flash_attention" in mods
    assert "repro_torch.kernels.ssm_scan" in mods
    assert "repro_torch.metrics.aggregate" in mods
    assert "repro_torch.configs.hparams" in mods
    for name in ("fig3_backward_lag", "fig4_sample_efficiency",
                 "fig11_tv_tracking", "fig5_rlvr_forward_lag",
                 "ablation_delta", "ablation_rho", "ablation_realignment"):
        assert f"repro_torch.experiments.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_jax_or_repro_in_an_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_engine_without_cpu_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.models.registry import build
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = build(reduced_config("qwen2.5-0.5b", vocab=64))
    params = bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(bundle, params)
    ServeEngine(bundle, params, device="cpu")            # asked for: fine


def test_launcher_without_cpu_raises_when_cuda_is_absent(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--engine", "continuous", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--engine", "static", "--arch", "rwkv6-1.6b"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--engine", "static", "--arch", "hymba-1.5b"])
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--engine", "static", "--speculate", "2"])


def test_trainer_and_train_launcher_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.launch import train
    from repro_torch.models.registry import build
    from repro_torch.train import RLVRHyperparams, RLVRTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RLVRTrainer(build(reduced_config("qwen2.5-0.5b", vocab=64)),
                    MathTaskDataset(prompt_len=16, pool_size=64),
                    RLVRHyperparams())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["rlvr", "--warmup-steps", "0"])


def test_rl_runner_and_launcher_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.launch import train
    from repro_torch.train import AsyncRLRunConfig, run_async_rl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_async_rl(AsyncRLRunConfig(n_actors=2, rollout_steps=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["rl", "--n-actors", "2", "--rollout-steps", "4"])


def test_producers_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.data.mathgen import MathTaskDataset
    from repro_torch.envs import make_env, wrap_autoreset
    from repro_torch.models.mlp_policy import act, mlp_policy_init
    from repro_torch.models.registry import build
    from repro_torch.rollout.async_engine import (ForwardLagGenerator,
                                                  SimulatedAsyncActors)
    from repro_torch.runtime import (FrozenRolloutProducer,
                                     MixtureRolloutProducer)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = wrap_autoreset(make_env("pendulum"))
    params = mlp_policy_init(torch.Generator().manual_seed(0), 3, 1)
    kw = dict(n_actors=2, rollout_steps=4)
    bundle = build(reduced_config("qwen2.5-0.5b", vocab=64))
    ds = MathTaskDataset(prompt_len=16, pool_size=64)
    gkw = dict(prompts_per_minibatch=1, completions_per_prompt=1,
               max_new_tokens=1)
    makers = (lambda **d: MixtureRolloutProducer(env, act, **kw, **d),
              lambda **d: FrozenRolloutProducer(env, act, **kw, **d),
              lambda **d: SimulatedAsyncActors(env, act, params,
                                               buffer_capacity=2, **kw, **d),
              lambda **d: ForwardLagGenerator(bundle, ds, **gkw, **d))
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        make(device="cpu")                   # asked for: fine


def test_experiment_runners_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.experiments import (fig3_backward_lag,
                                         fig5_rlvr_forward_lag)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fig3_backward_lag.main(["--envs", "pendulum", "--algorithms", "vaco",
                                "--capacities", "1", "--seeds", "0",
                                "--phases", "1", "--n-actors", "2",
                                "--rollout-steps", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fig5_rlvr_forward_lag.main(["--minibatches", "1", "--phases", "1",
                                    "--warmup-steps", "0"])


@pytest.mark.parametrize("flag", [["--controller", "gac"],
                                  ["--checkpoint-dir", "out"]])
def test_rl_launcher_refuses_unported_flags(flag):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="not ported"):
        train.main(["rl", "--device", "cpu", *flag])


def test_cuda_only_tests_skip_cleanly_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", str(ROOT / "tests" / "test_torch_cuda.py")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    if not torch.cuda.is_available():
        assert "skipped" in out.stdout and "passed" not in out.stdout, \
            out.stdout
