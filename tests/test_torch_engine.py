"""The slice as a whole: load_model(.nam, device="cpu") -> StreamEngine with
prewarm, against the JAX package's StreamEngine on the same document and
input. Tolerance 2e-5 absolute (the JAX package's tier-against-tier
tolerance)."""

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.utils.profiling import BlockTimer

ATOL = 2e-5


@pytest.mark.parametrize("kernel,T,B", [("auto", 64, 8), ("fused", 64, 8), ("fused", 32, 5), ("torch", 16, 3)])
def test_slice_matches_jax_stream_engine_with_prewarm(kernel, T, B):
    doc = make_nam("WaveNet", wavenet_preset("standard"), seed=17)
    jm = jnam.load_model(doc)
    tm = tnam.load_model(doc, device="cpu")
    je = JEngine(jm, batch=B, block_size=T, kernel="xla")
    te = tnam.StreamEngine(tm, batch=B, block_size=T, kernel=kernel)
    # auto on a CPU model is the torch tier: the kernel runs on the card only.
    assert te.kernel == {"auto": "torch", "fused": "fused", "torch": "torch"}[kernel]
    assert te.prewarm_plan() == (-(-jm.get_prewarm_samples() // T), 0)  # feed-forward: ceil blocks
    js, ts = je.reset(), te.reset()
    rng = np.random.default_rng(23)
    before = tstack.launches
    for i in range(4):
        blk = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        assert yt.shape == (B, T) and torch.isfinite(yt).all()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"block {i}")
    assert tstack.launches == before


def test_engine_argument_errors():
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("simple"), seed=0), device="cpu")
    with pytest.raises(ValueError, match="kernel must be"):
        tnam.StreamEngine(tm, batch=4, block_size=8, kernel="pallas")
    eng = tnam.StreamEngine(tm, batch=4, block_size=8)
    with pytest.raises(ValueError, match="block_size=8"):
        eng.process(np.zeros((4, 9), np.float32), eng.reset())


def test_block_timer_on_cpu():
    t = BlockTimer(deadline_s=64 / 48000)
    for _ in range(3):
        with t:
            torch.zeros(10).sum()
    s = t.stats()
    assert s["min"] <= s["p50"] <= s["max"] and s["rtf"] > 0
    assert len(t.times) == 3
