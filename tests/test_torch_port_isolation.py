"""The port stands alone: it imports nothing of JAX, flax or ``pwcnet_tpu``
(nor ``ml_dtypes``, which the GPU machine lacks: the bf16 checkpoint reader
views raw bits), and its entry points refuse to fall back to the CPU
silently.

The import check runs in a subprocess, because this test process already
imports JAX (``tests/conftest.py``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_port_util  # noqa: F401  (this process's share of the cores)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pwcnet_tpu", "ml_dtypes")

_CHECK = """
import importlib, pkgutil, sys
import pwcnet_tpu_torch
names = ["pwcnet_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    pwcnet_tpu_torch.__path__, "pwcnet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120,
        check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20  # every module of the package was imported
    assert out[1].strip() == "[]"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_sources_and_chip_smoke_name_no_forbidden_import():
    files = [REPO / "chip_smoke.py", *(REPO / "pwcnet_tpu_torch").rglob(
        "*.py")]
    for f in files:
        bad = set(_imported_roots(f)) & set(FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_model_without_device_raises_when_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: PWCNet() runs there")
    from pwcnet_tpu_torch import PWCNet
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PWCNet()


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd in (REPO, tmp_path):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
