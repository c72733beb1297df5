"""The port stands alone: no file of it, and not chip_smoke.py, imports JAX,
the JAX package or the repo-root ``tools/`` (the JAX tools that K4-K6 port);
its entry points run on the card unless the caller asks for the CPU;
chip_smoke.py refuses to run without a card or without the repository."""

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
FORBIDDEN = {"jax", "jaxlib", "neuralampmodelercore_tpu", "tools"}


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
    assert {
        "__init__.py", "models/engine.py", "models/wavenet.py", "models/lstm.py", "models/convnet.py",
        "ops/cuda/_build.py", "ops/cuda/stack.py", "ops/cuda/lstm.py", "ops/cuda/convnet.py",
        "cli/loadmodel.py", "cli/benchmodel.py", "tools/proto_ring_kernel.py", "tools/microbench_dots.py",
    } <= names
    for src in ("stack.cu", "stack_wf.cu", "lstm.cu", "convnet.cu", "activations.cuh", "stack.cuh", "proto_ring.cu",
                "dot_chain.cu"):
        assert (PORT / "csrc" / src).exists()


def test_build_key_covers_source_headers_and_flags(monkeypatch, tmp_path):
    """A library is keyed by its source, every csrc/*.cuh header and the
    flags: editing any of them builds anew instead of loading a stale .so.
    Nothing is compiled or loaded to compute the key."""
    from neuralampmodelercore_tpu_torch.ops.cuda import _build, convnet, lstm, stack

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.Library("k.cu", lambda lib: None)
    first = lib.path()
    assert first.parent == tmp_path / "build" and first.name.startswith("k_") and first.suffix == ".so"
    assert lib.path() == first
    (csrc / "h.cuh").write_text("// v2\n")
    second = lib.path()
    assert second != first
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert lib.path() not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert lib.path() != second
    assert not (tmp_path / "build").exists()
    # The port's kernels each have their own library and source; the stack
    # module has two (the unpacked and the wavefront kernel).
    assert [m.LIB.source.name for m in (stack, lstm, convnet)] == ["stack.cu", "lstm.cu", "convnet.cu"]
    assert stack.WF_LIB.source.name == "stack_wf.cu"


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
