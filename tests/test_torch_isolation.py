"""The port stands alone: ``repro_torch`` imports with JAX made unimportable,
loads no module of the JAX package, and its entry points refuse to fall
back to the CPU when CUDA is asked for but absent."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import bridge

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" \
                or name.startswith("jaxlib."):
            raise ImportError(f"{name} is blocked in this probe")
        return None

sys.meta_path.insert(0, _Block())
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" or m.startswith("jax."))
assert not loaded, loaded

import torch
assert not torch.cuda.is_available()
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.launch.serve import main
from repro_torch.bridge import to_torch
for call in (lambda: build_model(get_config("llama3.2-3b", "smoke")).init(0),
             lambda: build_model(get_config("mixtral-8x22b", "smoke")).init(0),
             lambda: main(["--adapters", "1", "--requests", "1"]),
             lambda: to_torch({"w": [1.0, 2.0]})):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("a device='cuda' entry point ran without a GPU")
print("isolated")
"""


def test_repro_torch_imports_without_jax_and_refuses_missing_cuda():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("isolated")


def test_no_jax_or_repro_import_in_source():
    for path in [*(SRC / "repro_torch").rglob("*.py"),
                 SRC.parent / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import", "import repro\n")), \
                f"{path}: {s}"
            assert s != "import repro", f"{path}: {s}"


@pytest.mark.parametrize("fn", ["to_torch", "quantized_tensor",
                                "quantized_lora", "quantized_adapter"])
def test_bridge_defaults_to_cuda(fn, monkeypatch):
    """Bridged objects land on the card unless the caller asks for the CPU:
    with no GPU the default raises instead of placing them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(bridge, fn)({"w": [1.0]})


def test_mesh_over_defaults_to_cuda(monkeypatch):
    """``mesh_over`` lays its mesh on the card unless the caller asks for the
    CPU, as every entry point of the port does: with no GPU the default
    raises before it touches a process group."""
    import inspect

    from repro_torch.launch.mesh import mesh_over

    assert inspect.signature(mesh_over).parameters["device"].default == \
        "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_over((1, 1))
