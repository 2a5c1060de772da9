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
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--engine", "static"])


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


def test_cuda_only_tests_skip_cleanly_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", str(ROOT / "tests" / "test_torch_cuda.py")],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    if not torch.cuda.is_available():
        assert "skipped" in out.stdout and "passed" not in out.stdout, \
            out.stdout
