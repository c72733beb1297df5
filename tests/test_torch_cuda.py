"""Tests that need the CUDA card: the stack kernel against its plain version
on the same CUDA inputs, and the main path's choice of the kernel.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch. Every test is marked ``cuda`` and skips, inside the
test, when there is no card. On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py imports JAX.) Tolerance 2e-5 absolute,
the JAX package's tier-against-tier tolerance."""

import pytest
import torch

import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools.generate import make_nam, wavenet_preset

ATOL = 2e-5

SPLICE = {
    "layers": [
        {"input_size": 1, "condition_size": 1, "channels": 8, "head_size": 1, "kernel_size": 3,
         "dilations": [3, 12, 28, 52], "activation": "Tanh", "gated": False, "head_bias": True}
    ],
    "head": None,
}


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name,T,B", [("standard", 64, 1024), ("standard", 16, 1000), ("splice", 16, 256)])
def test_kernel_matches_plain_version(name, T, B):
    _cuda_or_skip()
    config = wavenet_preset("standard") if name == "standard" else SPLICE
    tm = tnam.load_model(make_nam("WaveNet", config, seed=2))
    ep, sk = tstack.prepare(tm.config, tm.params, T, B)
    buf = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = tstack.launches
    for _ in range(6):
        x = torch.randn((1, T, B), generator=gen, device="cuda") * 0.3
        n = sk["n"]
        yk, sk = tstack.step(tm.config, T, ep, sk, x)
        yp = tstack.step_plain(ep["layout"], ep["weights"], buf, x, n)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
    assert tstack.launches == before + 6


@pytest.mark.cuda
def test_main_path_runs_the_kernel():
    """load_model defaults to the card; auto picks the kernel; one launch per
    block; the result matches the torch engine tier."""
    _cuda_or_skip()
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("standard"), seed=2))
    assert tm.device.type == "cuda"
    eng = tnam.StreamEngine(tm, batch=256, block_size=64)
    ref = tnam.StreamEngine(tm, batch=256, block_size=64, kernel="torch")
    assert eng.kernel == "fused" and ref.kernel == "torch"
    before = tstack.launches
    s, rs = eng.reset(), ref.reset()
    assert tstack.launches == before + eng.prewarm_blocks()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(4):
        x = torch.randn((256, 64), generator=gen, device="cuda") * 0.3
        y, s = eng.process(x, s)
        yr, rs = ref.process(x, rs)
        torch.testing.assert_close(y, yr, rtol=0, atol=ATOL)
    assert tstack.launches == before + eng.prewarm_blocks() + 4
