"""ConvNet tiers of the port against the JAX package.

The same document and the same numpy input go to both. The port's generic
tier runs blocks of mixed sizes against the JAX generic step over the whole
signal; its torch engine tier and its fused tier (on the CPU the K3 kernel's
plain version, ops/cuda/convnet.py ``step_plain``) run with prewarm against
the JAX ``StreamEngine(kernel="xla")``, and the fused tier against the JAX
Pallas kernel in interpret mode at B=128, as the JAX package's own tests run
it (tests/test_pallas_convnet.py:20-41). Tolerance 2e-5 absolute, the JAX
package's tier-against-tier tolerance. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops.pallas import convnet as jconv
from neuralampmodelercore_tpu.tools.generate import make_nam, with_condition_dsp
from neuralampmodelercore_tpu_torch.convert import params_from_jax
from neuralampmodelercore_tpu_torch.ops.cuda import backend_for
from neuralampmodelercore_tpu_torch.ops.cuda import convnet as tconv
from test_torch_stack_modes import modes

ATOL = 2e-5
B = 128  # one lane tile: the JAX kernel's smallest batch

CONFIGS = {
    # The amp ConvNet (tests/test_pallas_convnet.py:63-70 of the JAX package).
    "amp": {"channels": 16, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
            "batchnorm": True, "activation": "Tanh"},
    "no_bn_bias_relu": {"channels": 8, "dilations": [1, 2, 4], "batchnorm": False, "activation": "ReLU"},
    "groups2": {"channels": 8, "dilations": [1, 2], "batchnorm": True, "activation": "Tanh",
                "groups": 2, "in_channels": 2},
    "io2_silu": {"channels": 8, "dilations": [1, 2, 4], "batchnorm": True, "activation": "SiLU",
                 "in_channels": 2, "out_channels": 2},
    "depthwise": {"channels": 4, "dilations": [1, 3], "batchnorm": False, "activation": "Hardtanh",
                  "groups": 4, "in_channels": 4},
    # d=24 and d=40 at T=16: lookbacks that are not multiples of T (the JAX
    # kernel refuses them; the ring design of the port's kernel does not).
    "dilation_not_multiple": {"channels": 6, "dilations": [1, 24, 40], "batchnorm": True,
                              "activation": {"type": "LeakyHardtanh", "min_val": -0.5, "max_val": 0.7}},
}


@pytest.fixture(autouse=True)
def _interpret_mode():
    jconv.INTERPRET = True
    yield
    jconv.INTERPRET = False


def _models(name, seed=7):
    doc = make_nam("ConvNet", CONFIGS[name], seed=seed)
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
    """Bit-equal parameters, the BatchNorm fold included (float64, then cast)."""
    jm, tm = _models(name)
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.get_prewarm_samples() == jm.get_prewarm_samples() == 1 + sum(CONFIGS[name]["dilations"])
    assert tm.num_params() == jm.num_params()
    _assert_trees_equal(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), "cpu"), tm.params)


def test_batchnorm_fold_is_float64():
    """scale = w / sqrt(eps + var), loc = b - scale * mean in float64, then
    float32 (convnet.py:76-84 of the JAX package)."""
    doc = make_nam("ConvNet", CONFIGS["amp"], seed=3)
    tm = tnam.load_model(doc, device="cpu")
    w = np.asarray(doc["weights"], np.float32)
    pos = 2 * 1 * 16  # layer 0 conv: k=2, 1 -> 16 channels, no bias
    mean, var, bw, bb = (w[pos + i * 16 : pos + (i + 1) * 16].astype(np.float64) for i in range(4))
    eps = float(w[pos + 64])
    scale = bw / np.sqrt(eps + var)
    np.testing.assert_array_equal(tm.params["blocks"][0]["bn_scale"].numpy(), scale.astype(np.float32))
    np.testing.assert_array_equal(tm.params["blocks"][0]["bn_loc"].numpy(), (bb - scale * mean).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generic_tier_mixed_blocks_matches_jax(name):
    jm, tm = _models(name)
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    cin = CONFIGS[name].get("in_channels", 1)
    x = _input((2, 150, cin), seed=3)
    yj, _ = jm.process(x, jm.reset(batch=2))
    st = tm.reset(batch=2)
    ys = []
    for a, b in ((0, 37), (37, 101), (101, 106), (106, 150)):
        y, st = tm.process(x[:, a:b], st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def test_generic_prewarm_and_render_match_jax():
    jm, tm = _models("amp")
    x = _input((2, 40, 1), seed=5)
    yj, _ = jm.process(x, jm.reset(batch=2, max_buffer_size=100))
    yt, _ = tm.process(x, tm.reset(batch=2, max_buffer_size=100))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.render(x).numpy(), np.asarray(jm.render(x)), rtol=0, atol=ATOL)


def _engine_run(jm, tm, tier, T, batch, n_blocks, seed, jtier="xla"):
    """Both engines with prewarm (ceil blocks), then n_blocks with state carried."""
    je = JEngine(jm, batch=batch, block_size=T, kernel=jtier)
    te = tnam.StreamEngine(tm, batch=batch, block_size=T, kernel=tier)
    assert te.kernel == tier
    js, ts = je.reset(), te.reset()
    cin = tm.num_input_channels
    rng = np.random.default_rng(seed)
    for i in range(n_blocks):
        blk = (rng.standard_normal((batch, T, cin)) * 0.4).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        assert torch.isfinite(yt).all()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{tier} block {i}")
    return te


@pytest.mark.parametrize("tier", ["torch", "fused"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_tiers_match_jax_with_prewarm(tier, name):
    """T=16: the amp ConvNet's deep dilations wrap their rings (M up to 34)."""
    jm, tm = _models(name)
    before = tconv.launches
    te = _engine_run(jm, tm, tier, T=16, batch=3, n_blocks=6, seed=11)
    n = jm.get_prewarm_samples()
    assert te.prewarm_plan() == (-(-n // 16), 0)
    assert tconv.launches == before  # CPU tensors never launch the kernel


@pytest.mark.parametrize("name,T", [("amp", 64), ("no_bn_bias_relu", 16), ("groups2", 16), ("io2_silu", 16)])
def test_fused_tier_matches_jax_pallas_kernel(name, T):
    jm, tm = _models(name)
    _engine_run(jm, tm, "fused", T=T, batch=B, n_blocks=4, seed=12, jtier="pallas")


def test_fused_tier_ring_counter_wrap():
    """Enough blocks at T=16 that every ring of the amp ConvNet wraps and the
    block counter passes the LCM of the ring sizes."""
    jm, tm = _models("amp")
    te = tnam.StreamEngine(tm, batch=2, block_size=16, kernel="fused")
    wrap = te.params["layout"].wrap
    assert wrap > 34
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    je = JEngine(jm, batch=2, block_size=16, kernel="xla")
    js, ts = je.reset(prewarm=False), te.reset(prewarm=False)
    ts["n"] = wrap - 3  # same stream, counter three blocks below the wrap
    rng = np.random.default_rng(2)
    for i in range(40):
        blk = (rng.standard_normal((2, 16)) * 0.4).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        assert 0 <= ts["n"] < wrap
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"block {i}")


@pytest.mark.parametrize("tier", ["generic", "torch"])
def test_wavenet_with_convnet_condition_dsp(tier):
    sub = make_nam("ConvNet", {"channels": 4, "dilations": [1, 2, 8], "batchnorm": True, "activation": "Tanh",
                               "out_channels": 2}, seed=1)
    layer = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                 dilations=[1, 3], activation="Tanh", gated=False, head_bias=True)
    doc = make_nam("WaveNet", with_condition_dsp({"layers": [layer], "head": None}, sub), seed=2)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    assert tm.get_prewarm_samples() == jm.get_prewarm_samples()
    if tier == "generic":
        x = _input((2, 50, 1), seed=8)
        yj, _ = jm.process(x, jm.reset(batch=2, max_buffer_size=16))
        yt, _ = tm.process(x, tm.reset(batch=2, max_buffer_size=16))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
        return
    _engine_run(jm, tm, "torch", T=16, batch=3, n_blocks=4, seed=8)
    assert tnam.StreamEngine(tm, batch=3, block_size=16).kernel == "torch"  # auto on the CPU
    # The stack kernel takes it with the condition model as a pre-pass (K1e).
    from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack

    assert tstack.cond_mode(tm.config, 16) == "prepass"
    _engine_run(jm, tm, "fused", T=16, batch=3, n_blocks=4, seed=8)


def test_supports_gate_and_backend():
    _, tm = _models("amp")
    assert backend_for(tm.config) is tconv
    for T, batch in ((64, 2048), (16, 1000), (1, 1), (512, 3)):
        assert tconv.supports(tm.config, T, batch) is None, (T, batch)
    assert tconv.supports(tm.config, 1024, 8) is None  # the wide kernel (a thread runs several frames)
    assert "block size" in tconv.supports(tm.config, 2048, 8)  # the JAX gate refuses it too
    assert "ConvNetConfig" in tconv.supports(object(), 64, 8)
    # A lookback that is not a multiple of T: the JAX kernel refuses, this one runs it.
    _, tn = _models("dilation_not_multiple")
    assert jconv.supports(jnam.load_model(make_nam("ConvNet", CONFIGS["dilation_not_multiple"], seed=7)).config,
                          16, B) is not None
    assert tconv.supports(tn.config, 16, B) is None
    # Beyond convnet.cu's register tile, the wide kernel (csrc/convnet_wide.cu) runs them.
    admitted = {
        "channels": {"channels": 40, "dilations": [1], "batchnorm": False, "activation": "Tanh"},
        "per-channel PReLU": {"channels": 4, "dilations": [1], "batchnorm": False,
                              "activation": {"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3, 0.4]}},
    }
    for why, cfg in admitted.items():
        m = tnam.load_model(make_nam("ConvNet", cfg, seed=0), device="cpu")
        assert tconv.supports(m.config, 16, 8) is None, why
        assert tconv.prepare(m.config, m.params, 16, 8)[0]["layout"].wide_threads > 0, why
        assert tnam.StreamEngine(m, batch=8, block_size=16, kernel="fused").kernel == "fused"
    refused = {
        "more than 128 channels": {"channels": 129, "dilations": [1], "batchnorm": False, "activation": "Tanh"},
        "PReLU with 3 slopes on 4 channels": {"channels": 4, "dilations": [1], "batchnorm": False,
                                              "activation": {"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3]}},
    }
    for why, cfg in refused.items():
        m = tnam.load_model(make_nam("ConvNet", cfg, seed=0), device="cpu")
        reason = tconv.supports(m.config, 16, 8)
        assert reason is not None and why in reason, (why, reason)
        assert tnam.StreamEngine(m, batch=8, block_size=16).kernel == "torch"
        with pytest.raises(ValueError, match="fused kernel does not support"):
            tnam.StreamEngine(m, batch=8, block_size=16, kernel="fused")


@pytest.mark.parametrize("mode", ["fast_tanh", "lut"])
def test_supports_refuses_fast_tanh_and_lut_modes(mode):
    """supports admits both modes (K1f), the fused tier matches the JAX
    Pallas kernel under the same mode (on a Tanh ConvNet), and a mode
    switched on after an engine was built raises."""
    _, tm = _models("no_bn_bias_relu")
    eng = tnam.StreamEngine(tm, batch=4, block_size=16, kernel="fused")
    state = eng.reset(prewarm=False)
    with modes(*((True, ()) if mode == "fast_tanh" else (False, (("Tanh", -3.0, 3.0, 64),)))):
        jm, ta = _models("groups2")
        assert tconv.supports(tm.config, 16, 4) is None and tconv.supports(ta.config, 16, B) is None
        _engine_run(jm, ta, "fused", T=16, batch=B, n_blocks=3, seed=12, jtier="pallas")
        with pytest.raises(ValueError, match="modes changed since the fused engine was built"):
            eng.process(np.zeros((4, 16), np.float32), state)


def test_work_counts_for_the_bound():
    """The amp ConvNet: 4,656 MACs per sample counting the head and not the
    bias adds; 41,224 bytes of state and I/O per stream and block at T=64."""
    _, tm = _models("amp")
    w = tconv.work(tm.config, 64, 2048)
    assert w["macs"] == 4656 * 64 * 2048 and w["flops"] == 2 * w["macs"]
    n_weights = 2 * 1 * 16 + 9 * 2 * 16 * 16 + 10 * 2 * 16 + 16 + 1
    assert w["bytes"] == 41224 * 2048 + 4 * n_weights


def test_wrapper_refuses_other_devices_and_bad_shapes():
    _, tm = _models("no_bn_bias_relu")
    ep, st = tconv.prepare(tm.config, tm.params, 16, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tconv.step(tm.config, 16, ep, st, torch.zeros(1, 16, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tconv.launch(ep["layout"], ep["weights"], ep["plan"], st["buf"], torch.zeros(1, 16, 4), 0)
