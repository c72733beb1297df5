"""The port stands alone: no file of it, and not chip_smoke.py, imports JAX
or the JAX package; its entry points run on the card unless the caller asks
for the CPU; chip_smoke.py refuses to run without a card or without the
repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu_torch.tools.generate import make_nam, wavenet_preset

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "neuralampmodelercore_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "neuralampmodelercore_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"__init__.py", "ops/cuda/stack.py", "models/engine.py", "models/wavenet.py"} <= names
    assert (PORT / "csrc" / "stack.cu").exists()


def test_load_model_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    doc = make_nam("WaveNet", wavenet_preset("simple"), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnam.load_model(doc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnam.load_model(doc, device="cuda")
    assert tnam.load_model(doc, device="cpu").device.type == "cpu"


def test_precision_flags():
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
