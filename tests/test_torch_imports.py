"""The port stands alone: no JAX and nothing of the JAX package.

* every ``repro_torch`` module imports in a fresh interpreter in which
  ``jax`` and ``repro`` cannot be imported;
* no ``import`` statement in ``src/repro_torch/``, in ``chip_smoke.py``
  or in the port's sweep scripts (``scripts/k*_sweep.py``) names
  ``jax``, ``jaxlib`` or ``repro`` (the scripts run only on the card);
* entry points default to the CUDA device and raise without one: the
  model's, the converters', the engines', the trainer's and both
  launchers'.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("k*_sweep.py")))


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and v is not None"
        " for k, v in sys.modules.items())\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path}:{node.lineno} {roots}"


def test_default_device_is_cuda_and_raises_without_it():
    from repro_torch import resolve_device
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for call in (resolve_device, lambda: init_params(
            smoke_config("qwen2.5-0.5b"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"


def _entry_points():
    """Each public entry point called with no device, on a smoke
    config's CPU weights where it needs them."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import cache_from_jax, params_from_jax
    from repro_torch.launch import serve, train
    from repro_torch.models import init_cache
    from repro_torch.serve import make_engine
    from repro_torch.train import Trainer, TrainerConfig

    arch = "internvl2-76b"
    cfg = smoke_config(arch)
    return {
        "init_cache": lambda: init_cache(cfg, 1, 8, torch.float32),
        "params_from_jax": lambda: params_from_jax({"groups": []}, cfg),
        "cache_from_jax": lambda: cache_from_jax([], cfg),
        "make_engine": lambda: make_engine(cfg, _cpu_params(cfg)),
        "Trainer": lambda: Trainer(cfg, TrainerConfig(steps=1)),
        "launch.serve": lambda: serve.main(["--arch", arch, "--smoke"]),
        "launch.train": lambda: train.main(["--arch", arch, "--smoke"]),
    }


def _cpu_params(cfg):
    from repro_torch.models import init_params
    return init_params(cfg, device="cpu")


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
