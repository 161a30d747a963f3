"""The port stands alone: it loads no JAX and nothing of the JAX package,
and its entry points refuse to fall back to the CPU unasked."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=full_env, timeout=120)


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


def test_no_source_file_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("call", [
    "from repro_torch.launch.serve import main; main(['--reduced'])",
    "from repro_torch.configs import get; from repro_torch.models import Model; "
    "Model(get('qwen3-8b').reduced())",
    "from repro_torch import resolve_device; resolve_device('cuda')",
    "from repro_torch import api; from repro_torch.configs import get; "
    "from repro_torch.models import Model; "
    "api.LivePlane(engine='torch', model=Model(get('qwen3-8b')), params={})",
])
def test_entry_points_raise_without_a_card(call):
    res = _run(call, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
