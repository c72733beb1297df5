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
        tnam.StreamEngine(tm, batch=4, block_size=8, kernel="wavefront")  # JAX's opt-in tier, not ported
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


@pytest.mark.parametrize("name,tier", [("pallas", "fused"), ("xla", "torch")])
def test_jax_tier_names_run_the_ports_tiers(name, tier):
    """Code written for the JAX package passes its tier names: "pallas" runs
    the port's fused tier (on the CPU its kernel's plain version), "xla" the
    torch tier, each matching the JAX StreamEngine on the same blocks."""
    doc = make_nam("WaveNet", wavenet_preset("standard"), seed=5)
    je = JEngine(jnam.load_model(doc), batch=4, block_size=32, kernel="xla")
    te = tnam.StreamEngine(tnam.load_model(doc, device="cpu"), batch=4, block_size=32, kernel=name)
    assert te.kernel == tier
    js, ts = je.reset(), te.reset()
    rng = np.random.default_rng(5)
    for _ in range(3):
        blk = (rng.standard_normal((4, 32)) * 0.3).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def test_set_matmul_precision_takes_only_float32_names():
    """The JAX package's ``set_matmul_precision`` takes six names; the port
    takes the two that mean float32-exact products ("highest", "float32",
    any case), as the JAX package maps both to Precision.HIGHEST, and
    raises on the four that lower the precision (the North star's rule)."""
    import jax

    from neuralampmodelercore_tpu.ops import layers as jlayers

    saved = jlayers.MATMUL_PRECISION
    try:
        for name in ("highest", "float32", "HIGHEST"):
            jnam.set_matmul_precision(name)
            assert jlayers.MATMUL_PRECISION == jax.lax.Precision.HIGHEST
            tnam.set_matmul_precision(name)
            assert torch.get_float32_matmul_precision() == "highest"
        for name in ("high", "bfloat16_3x", "default", "bfloat16"):
            jnam.set_matmul_precision(name)
            assert jlayers.MATMUL_PRECISION != jax.lax.Precision.HIGHEST
            with pytest.raises(ValueError, match="float32-exact"):
                tnam.set_matmul_precision(name)
        with pytest.raises(KeyError):
            jnam.set_matmul_precision("fp8")
        with pytest.raises(ValueError, match="float32-exact"):
            tnam.set_matmul_precision("fp8")
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        jlayers.MATMUL_PRECISION = saved
    assert "set_matmul_precision" in tnam.__all__ and "set_matmul_precision" in jnam.__all__
