"""LSTM tiers of the port against the JAX package.

The same document and the same numpy input go to both. The port's generic
tier runs blocks of mixed sizes against the JAX generic step over the whole
signal; its torch engine tier and its fused tier (on the CPU the K2 kernel's
plain version, ops/cuda/lstm.py ``step_plain``) run with the exact prewarm
against the JAX ``StreamEngine(kernel="xla")``, and the fused tier against
the JAX Pallas kernel in interpret mode at B=128, as the JAX package's own
tests run it (tests/test_pallas_lstm.py:22-43). ``sample_rate=496`` makes
the 0.5 s prewarm 248 samples: 15 blocks of 16 and an 8-sample remainder.
Tolerance 2e-5 absolute, the JAX package's tier-against-tier tolerance. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops import activations as jact
from neuralampmodelercore_tpu.ops.pallas import lstm as jlstm
from neuralampmodelercore_tpu.tools.generate import make_nam, with_condition_dsp
from neuralampmodelercore_tpu_torch.convert import params_from_jax
from neuralampmodelercore_tpu_torch.ops import activations as tact
from neuralampmodelercore_tpu_torch.ops.cuda import backend_for
from neuralampmodelercore_tpu_torch.ops.cuda import lstm as tlstm

ATOL = 2e-5
B = 128  # one lane tile: the JAX kernel's smallest batch

CONFIGS = {
    "1x3": {"input_size": 1, "hidden_size": 3, "num_layers": 1},
    "2x16": {"input_size": 1, "hidden_size": 16, "num_layers": 2},
    "2x5_out2": {"input_size": 1, "hidden_size": 5, "num_layers": 2, "out_channels": 2},
    "passthrough": {"input_size": 1, "hidden_size": 4, "num_layers": 0, "out_channels": 2},
}
KERNEL_CONFIGS = ["1x3", "2x16", "2x5_out2"]


@pytest.fixture(autouse=True)
def _interpret_mode():
    jlstm.INTERPRET = True
    yield
    jlstm.INTERPRET = False


def _models(name, seed=7, sample_rate=496):
    doc = make_nam("LSTM", CONFIGS[name], seed=seed, sample_rate=sample_rate)
    return jnam.load_model(doc), tnam.load_model(doc, device="cpu")


def _input(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.4).astype(np.float32)


def _assert_trees_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parsed_config_and_params_match_jax(name):
    jm, tm = _models(name)
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.get_prewarm_samples() == jm.get_prewarm_samples() == 248
    assert tm.num_params() == jm.num_params()
    _assert_trees_equal(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), "cpu"), tm.params)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generic_tier_mixed_blocks_matches_jax(name):
    """State carried across blocks of mixed sizes (block-size invariance),
    from the h0 / c0 of the weight stream."""
    jm, tm = _models(name)
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    x = _input((3, 90, 1), seed=3)
    yj, _ = jm.process(x, jm.reset(batch=3))
    st = tm.reset(batch=3)
    ys = []
    for a, b in ((0, 1), (1, 33), (33, 40), (40, 90)):
        y, st = tm.process(x[:, a:b], st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def test_generic_prewarm_and_render_match_jax():
    jm, tm = _models("2x16")
    x = _input((2, 40, 1), seed=5)
    yj, _ = jm.process(x, jm.reset(batch=2, max_buffer_size=100))
    yt, _ = tm.process(x, tm.reset(batch=2, max_buffer_size=100))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.render(x).numpy(), np.asarray(jm.render(x)), rtol=0, atol=ATOL)


def _engine_run(jm, tm, tier, T, batch, n_blocks, seed, jtier="xla"):
    """Both engines with the exact prewarm, then n_blocks with state carried."""
    je = JEngine(jm, batch=batch, block_size=T, kernel=jtier)
    te = tnam.StreamEngine(tm, batch=batch, block_size=T, kernel=tier)
    assert te.kernel == tier
    js, ts = je.reset(), te.reset()
    rng = np.random.default_rng(seed)
    for i in range(n_blocks):
        blk = (rng.standard_normal((batch, T)) * 0.4).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        assert torch.isfinite(yt).all()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{tier} block {i}")
    return te


@pytest.mark.parametrize("tier", ["torch", "fused"])
@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_engine_tiers_match_jax_with_exact_prewarm(tier, name):
    jm, tm = _models(name)
    before = tlstm.launches
    te = _engine_run(jm, tm, tier, T=16, batch=5, n_blocks=4, seed=11)
    assert te.prewarm_plan() == (15, 8)
    assert tlstm.launches == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_fused_tier_matches_jax_pallas_kernel(name):
    """The JAX Pallas kernel in interpret mode, its prewarm remainder step
    re-traced at T=8 against the same state (engine.py:137-168)."""
    jm, tm = _models(name)
    _engine_run(jm, tm, "fused", T=16, batch=B, n_blocks=4, seed=12, jtier="pallas")


def test_half_second_prewarm_at_44k1():
    """The main path's prewarm: 0.5 s at 44.1 kHz = 22,050 samples = 344
    blocks of 64 and a 34-sample remainder, on both tiers."""
    jm, tm = _models("2x16", sample_rate=44100)
    for tier in ("torch", "fused"):
        te = _engine_run(jm, tm, tier, T=64, batch=2, n_blocks=4, seed=13)
        assert te.prewarm_plan() == (344, 34)


def test_remainder_step_is_exact_not_rounded_up():
    """Extra zero samples move a recurrent state that has not settled:
    rounding the prewarm up to whole blocks would give another stream than
    the reference's. sample_rate=40: 20 samples = one block of 16 and 4."""
    jm, tm = _models("2x16", sample_rate=40)
    te = tnam.StreamEngine(tm, batch=2, block_size=16, kernel="fused")
    assert te.prewarm_plan() == (1, 4)
    exact = te.reset()
    rounded = te.reset(prewarm=False)
    for _ in range(2):
        _, rounded = te.step(rounded, torch.zeros(1, 16, 2))
    assert not torch.allclose(exact["h"], rounded["h"], rtol=0, atol=1e-6)
    ref = tm.reset(batch=2)  # the generic tier's exact prewarm
    for li in range(2):
        np.testing.assert_allclose(exact["h"][li].numpy(), ref["h"][li].numpy().T, rtol=0, atol=ATOL)
        np.testing.assert_allclose(exact["c"][li].numpy(), ref["c"][li].numpy().T, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tier", ["generic", "torch", "fused"])
def test_fast_tanh_mode(tier):
    """Global fast-tanh switches the cell to fast_sigmoid / fast_tanh
    (reference: NAM/lstm.cpp:48-58) in every tier of both packages."""
    jm, tm = _models("2x16")
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    x = _input((4, 48), seed=9)
    jact.enable_fast_tanh()
    tact.enable_fast_tanh()
    try:
        yj, _ = jm.process(x, jm.reset(batch=4))
        if tier == "generic":
            yt, _ = tm.process(x, tm.reset(batch=4))
        else:
            te = tnam.StreamEngine(tm, batch=4, block_size=16, kernel=tier)
            st = te.reset()
            ys = []
            for i in range(3):
                y, st = te.process(x[:, 16 * i : 16 * (i + 1)], st)
                ys.append(y)
            yt = torch.cat(ys, dim=1)
    finally:
        jact.disable_fast_tanh()
        tact.disable_fast_tanh()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    # The mode changes the result: it is not ignored. (The port runs eagerly;
    # the JAX step stays traced in fast mode for these shapes.)
    y_exact, _ = tm.process(x, tm.reset(batch=4))
    assert (y_exact - yt).abs().max().item() > 1e-4


def test_passthrough_tiers_match_jax():
    """num_layers == 0 copies the input to the first output channel
    (reference: lstm.cpp:141-151); the kernel refuses it, auto takes torch."""
    jm, tm = _models("passthrough")
    assert "passthrough" in tlstm.supports(tm.config, 16, 4)
    te = _engine_run(jm, tm, "torch", T=16, batch=4, n_blocks=2, seed=4)
    assert tnam.StreamEngine(tm, batch=4, block_size=16).kernel == "torch"
    assert te.model.num_output_channels == 2
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    x = _input((2, 20, 1), seed=6)
    yj, _ = jm.process(x, jm.reset(batch=2))
    yt, _ = tm.process(x, tm.reset(batch=2))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("tier", ["generic", "torch"])
def test_wavenet_with_lstm_condition_dsp(tier):
    """A WaveNet whose condition DSP is an LSTM loads, stays non-recurrent at
    the architecture level as in the JAX package (ceil prewarm blocks), and
    matches it, on the torch tier and on the stack kernel with the LSTM as a
    pre-pass (K1e)."""
    sub = make_nam("LSTM", {"input_size": 1, "hidden_size": 4, "num_layers": 1, "out_channels": 2},
                   seed=1, sample_rate=496)
    layer = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                 dilations=[1, 3], activation="Tanh", gated=False, head_bias=True)
    doc = make_nam("WaveNet", with_condition_dsp({"layers": [layer], "head": None}, sub), seed=2, sample_rate=496)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    assert tm.get_prewarm_samples() == jm.get_prewarm_samples()
    if tier == "generic":
        x = _input((2, 50, 1), seed=8)
        yj, _ = jm.process(x, jm.reset(batch=2, max_buffer_size=64))
        yt, _ = tm.process(x, tm.reset(batch=2, max_buffer_size=64))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        return
    te = _engine_run(jm, tm, "torch", T=16, batch=3, n_blocks=4, seed=8)
    assert te.prewarm_plan() == (-(-tm.get_prewarm_samples() // 16), 0)
    assert tnam.StreamEngine(tm, batch=3, block_size=16).kernel == "torch"  # auto on the CPU
    # The stack kernel takes it with the condition model as a pre-pass (K1e).
    from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack

    assert tstack.cond_mode(tm.config, 16) == "prepass"
    _engine_run(jm, tm, "fused", T=16, batch=3, n_blocks=4, seed=8)


def test_supports_gate_and_backend():
    _, tm = _models("2x16")
    assert backend_for(tm.config) is tlstm
    for T, batch in ((64, 2048), (34, 2048), (1, 1), (64, 1000), (4096, 3)):
        assert tlstm.supports(tm.config, T, batch) is None, (T, batch)
    assert "batch" in tlstm.supports(tm.config, 64, 0)
    assert "LSTMConfig" in tlstm.supports(object(), 64, 8)
    # Beyond lstm.cu's registers, the wide kernel (csrc/lstm_wide.cu) runs them.
    admitted = {
        "hidden_size": {"input_size": 1, "hidden_size": 40, "num_layers": 1},
        "layers": {"input_size": 1, "hidden_size": 4, "num_layers": 5},
        "in_channels 5": {"input_size": 5, "hidden_size": 4, "num_layers": 1, "in_channels": 5},
    }
    for why, cfg in admitted.items():
        m = tnam.load_model(make_nam("LSTM", cfg, seed=0), device="cpu")
        assert tlstm.supports(m.config, 64, 8) is None, why
        assert tlstm.prepare(m.config, m.params, 64, 8)[0]["layout"].wide_group > 0, why
        assert tnam.StreamEngine(m, batch=8, block_size=16, kernel="fused").kernel == "fused"
    refused = {
        "hidden_size 65 > 64": {"input_size": 1, "hidden_size": 65, "num_layers": 1},
        "9 layers > 8": {"input_size": 1, "hidden_size": 4, "num_layers": 9},
        "input_size": {"input_size": 2, "hidden_size": 4, "num_layers": 1},
        "in_channels 9 > 8": {"input_size": 9, "hidden_size": 4, "num_layers": 1, "in_channels": 9},
    }
    for why, cfg in refused.items():
        m = tnam.load_model(make_nam("LSTM", cfg, seed=0), device="cpu")
        reason = tlstm.supports(m.config, 64, 8)
        assert reason is not None and why in reason, (why, reason)
        assert tnam.StreamEngine(m, batch=8, block_size=16).kernel == "torch"
        with pytest.raises(ValueError, match="fused kernel does not support"):
            tnam.StreamEngine(m, batch=8, block_size=16, kernel="fused")
    # Larger LSTMs (3 x 24, 4 x 32) fit: their h stays within 128 registers.
    for L, H in ((3, 24), (4, 32)):
        m = tnam.load_model(make_nam("LSTM", {"input_size": 1, "hidden_size": H, "num_layers": L}, seed=0),
                            device="cpu")
        assert tlstm.supports(m.config, 64, 8) is None


def test_packed_weights_read_back_exactly():
    _, tm = _models("2x5_out2")
    ep, st = tlstm.prepare(tm.config, tm.params, 16, 3)
    layers, (hw, hb) = tlstm.unpack(ep["layout"], ep["weights"])
    for (w, b), lp in zip(layers, tm.params["layers"]):
        assert torch.equal(w, lp["w"].t()) and torch.equal(b, lp["b"])
    assert torch.equal(hw, tm.params["head_w"].t()) and torch.equal(hb, tm.params["head_b"])
    assert st["h"].shape == st["c"].shape == (2, 5, 3)
    assert torch.equal(st["c"][1, :, 2], tm.params["layers"][1]["c0"])


def test_work_counts_for_the_bound():
    """2 layers x H=16: 3,152 MACs per sample counting the head and not the
    bias adds; 1,024 bytes per stream and block of x, y, h and c at T=64."""
    _, tm = _models("2x16")
    w = tlstm.work(tm.config, 64, 32768)
    assert w["macs"] == 3152 * 64 * 32768 and w["flops"] == 2 * w["macs"]
    n_weights = 4 * 16 * (1 + 16 + 1) + 4 * 16 * (16 + 16 + 1) + 16 + 1
    assert w["bytes"] == 1024 * 32768 + 4 * n_weights


def test_wrapper_refuses_other_devices_and_bad_shapes():
    _, tm = _models("1x3")
    ep, st = tlstm.prepare(tm.config, tm.params, 16, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tlstm.step(tm.config, 16, ep, st, torch.zeros(1, 16, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlstm.launch(ep["layout"], ep["weights"], st["h"], st["c"], torch.zeros(1, 16, 4))
