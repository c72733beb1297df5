"""The fused stack step of the port (ops/cuda/stack.py) against the JAX
package's fused Pallas stack kernel and its XLA engine tier.

On the CPU the port's wrapper runs the kernel's plain version (same step,
same state layout, in torch); the JAX kernel runs in interpret mode, as the
JAX package's own tests run it (tests/test_pallas_stack.py:25-29). B=128 is
one lane tile, the JAX kernel's smallest batch. Tolerance 2e-5 absolute, the
JAX package's tier-against-tier tolerance. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops.pallas import stack as jstack
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset, with_condition_dsp
from neuralampmodelercore_tpu_torch.ops.cuda import backend_for
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from test_torch_stack_modes import modes

B = 128
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    jstack.INTERPRET = True
    yield
    jstack.INTERPRET = False


def splice_config(layer1x1=True):
    lc = {
        "input_size": 1, "condition_size": 1, "channels": 8, "head_size": 1, "kernel_size": 3,
        "dilations": [3, 12, 28, 52], "activation": "Tanh", "gated": False, "head_bias": True,
    }
    if not layer1x1:
        lc["layer1x1"] = {"active": False, "groups": 1}
    return {"layers": [lc], "head": None}


def _run(config, T, n_blocks, seed=7, tiers=("pallas", "xla")):
    doc = make_nam("WaveNet", config, seed=seed)
    jm = jnam.load_model(doc)
    tm = tnam.load_model(doc, device="cpu")
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    cin = tm.num_input_channels
    shape = (B, n_blocks * T) if cin == 1 else (B, n_blocks * T, cin)
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)
    fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    assert fe.kernel == "fused"
    fs = fe.reset(prewarm=False)
    jes = {k: JEngine(jm, batch=B, block_size=T, kernel=k) for k in tiers}
    jss = {k: e.reset(prewarm=False) for k, e in jes.items()}
    before = tstack.launches
    for i in range(n_blocks):
        blk = x[:, i * T : (i + 1) * T]
        yt, fs = fe.process(blk, fs)
        for k, e in jes.items():
            yj, jss[k] = e.process(blk, jss[k])
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{k} block {i}")
    assert tstack.launches == before  # CPU tensors never launch the kernel
    return fe, fs


def test_standard_T64():
    _run(wavenet_preset("standard"), T=64, n_blocks=3)


def test_standard_T16_ring_wrap():
    """T=16: the deep dilations wrap their rings (M up to 66 slots)."""
    _run(wavenet_preset("standard"), T=16, n_blocks=6, tiers=("xla",))


def test_standard_T16_against_pallas():
    _run(wavenet_preset("standard"), T=16, n_blocks=2, tiers=("pallas",))


def test_offset_splice_dilations():
    """Dilations not aligned to T: every deep tap window straddles two blocks."""
    _run(splice_config(), T=16, n_blocks=10)


def test_layer1x1_off():
    _run(splice_config(layer1x1=False), T=16, n_blocks=8)


def test_grouped_and_depthwise_weights():
    """Depthwise conv and grouped layer1x1 are densified at prepare."""
    config = splice_config()
    config["layers"][0].update(channels=4, groups_input=4, layer1x1={"active": True, "groups": 2})
    _run(config, T=16, n_blocks=4)


def test_multi_channel_input_padding_and_activations():
    """Two input channels, channel counts padded to the register tile (6 -> 8,
    5 -> 8), mixed kernel sizes including k=1, and every kernel activation."""
    acts = ["Tanh", "ReLU", "Sigmoid", "Hardtanh", {"type": "LeakyReLU", "negative_slope": 0.2},
            "SiLU", "Softsign", "Hardswish", "Fasttanh",
            {"type": "LeakyHardtanh", "min_val": -0.5, "max_val": 0.7, "min_slope": 0.1, "max_slope": 0.05},
            {"type": "PReLU", "negative_slope": 0.3}]
    config = {
        "in_channels": 2,
        "layers": [
            {"input_size": 2, "condition_size": 2, "channels": 6, "head_size": 5,
             "kernel_sizes": [2, 3, 4, 3, 2, 3, 3, 1, 3, 2, 3],
             "dilations": [1, 3, 7, 16, 33, 64, 5, 1, 100, 9, 2],
             "activation": acts, "gated": False, "head_bias": False},
            {"input_size": 6, "condition_size": 2, "channels": 5, "head_size": 2, "kernel_size": 3,
             "dilations": [2, 40], "activation": "Softsign", "layer1x1": {"active": False, "groups": 1},
             "gated": False, "head_bias": True},
        ],
        "head": None,
    }
    doc = make_nam("WaveNet", config, seed=3)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    T, nb = 32, 6
    x = (np.random.default_rng(3).standard_normal((B, nb * T, 2)) * 0.3).astype(np.float32)
    yj, _ = jm.process(x, jm.reset(batch=B))
    fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    fs = fe.reset(prewarm=False)
    ys = []
    for i in range(nb):
        y, fs = fe.process(x[:, i * T : (i + 1) * T], fs)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def test_ring_counter_wrap_soak():
    """The block counter wraps at the LCM of the ring sizes: a state whose
    counter sits just below int32 max (and = 0 mod the wrap) gives
    bit-identical output to a fresh stream across the wrap, twice."""
    doc = make_nam("WaveNet", splice_config(), seed=5)
    tm = tnam.load_model(doc, device="cpu")
    jm = jnam.load_model(doc)
    T = 8
    eng = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    layout = eng.params["layout"]
    wrap = 1
    for lp in layout.layers:
        if lp.M:
            wrap = wrap * lp.M // math.gcd(wrap, lp.M)
    assert layout.wrap == wrap > 1
    s_ref = eng.reset(prewarm=False)
    s_big = eng.reset(prewarm=False)
    s_big["n"] = (2**31 - 1) // wrap * wrap
    je = JEngine(jm, batch=B, block_size=T, kernel="xla")
    js = je.reset(prewarm=False)
    rng = np.random.default_rng(11)
    for i in range(2 * wrap + 3):
        blk = (rng.standard_normal((B, T)) * 0.3).astype(np.float32)
        y1, s_ref = eng.process(blk, s_ref)
        y2, s_big = eng.process(blk, s_big)
        assert torch.equal(y1, y2), f"block {i}"
        assert 0 <= s_big["n"] < wrap
        if i < 6:
            yj, js = je.process(blk, js)
            np.testing.assert_allclose(y1.numpy(), np.asarray(yj), rtol=0, atol=ATOL)


def _layer(**kw):
    base = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                dilations=[1, 2], activation="Tanh", gated=False, head_bias=True)
    base.update(kw)
    return base


# What K1b-K1e brought into the kernel: each of these was refused before
# them and now runs fused and matches the JAX package.
ADMITTED = {
    "gated": {"layers": [_layer(gated=True)], "head": None},
    "blended": {"layers": [_layer(gating_mode="blended")], "head": None},
    "bottleneck": {"layers": [_layer(channels=4, bottleneck=2)], "head": None},
    "head1x1": {"layers": [_layer(head1x1={"active": True, "out_channels": 2, "groups": 1})], "head": None},
    "film": {"layers": [_layer(conv_post_film={"active": True})], "head": None},
    "head_rechannel_k3": {"layers": [_layer(head={"out_channels": 1, "kernel_size": 3, "bias": True})]},
    "post_head": {"layers": [_layer(head_size=2)],
                  "head": {"channels": 2, "out_channels": 1, "kernel_sizes": [1], "activation": "Tanh"}},
    "condition_dsp": with_condition_dsp({"layers": [_layer()], "head": None},
                                        make_nam("WaveNet", wavenet_preset("simple"), seed=1)),
    "prelu_per_channel": {"layers": [_layer(activation={"type": "PReLU", "negative_slopes": [0.1, 0.2]})],
                          "head": None},
}

# Beyond the register tile -- more than 32 channels, more than 4 input
# channels -- the wide kernel (csrc/stack_wide.cu) runs them.
REFUSED = {
    "wide": {"layers": [_layer(channels=40)], "head": None},
    "many_inputs": {"in_channels": 5, "layers": [_layer(input_size=5, condition_size=5)], "head": None},
}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_admitted_features_run_fused(name):
    tm = tnam.load_model(make_nam("WaveNet", ADMITTED[name], seed=0), device="cpu")
    assert tstack.supports(tm.config, 16, B) is None
    _run(ADMITTED[name], T=16, n_blocks=6, tiers=("xla",))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_supports_refuses_what_is_not_k1a(name):
    """Beyond the register tile's limits -- more than 32 channels, more than
    4 input channels -- the wide kernel runs the model: supports admits it,
    the layout is the wide kernel's, and the fused tier matches the JAX
    Pallas kernel and XLA tier. (What stays refused: tests/test_torch_wide.py.)"""
    tm = tnam.load_model(make_nam("WaveNet", REFUSED[name], seed=0), device="cpu")
    assert tstack.supports(tm.config, 16, B) is None
    ep, _ = tstack.prepare(tm.config, tm.params, 16, 4)
    assert ep["layout"].wide is not None
    _run(REFUSED[name], T=16, n_blocks=4)


@pytest.mark.parametrize("mode", ["fast_tanh", "lut"])
def test_supports_refuses_fast_tanh_and_lut_modes(mode):
    """supports admits both modes (K1f), the fused tier matches the JAX
    Pallas kernel under the same mode, and a mode switched on after an
    engine was built raises: the engine baked in the activations of the
    modes it was built under."""
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("simple"), seed=0), device="cpu")
    eng = tnam.StreamEngine(tm, batch=B, block_size=16, kernel="fused")
    state = eng.reset(prewarm=False)
    with modes(*((True, ()) if mode == "fast_tanh" else (False, (("Tanh", -3.0, 3.0, 64),)))):
        assert tstack.supports(tm.config, 16, B) is None
        _run(wavenet_preset("simple"), T=16, n_blocks=4, seed=0, tiers=("pallas",))
        with pytest.raises(ValueError, match="modes changed since the fused engine was built"):
            eng.process(np.zeros((B, 16), np.float32), state)


def test_supports_block_size_and_backend():
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("standard"), seed=0), device="cpu")
    assert backend_for(tm.config) is tstack
    assert tstack.supports(tm.config, 64, 4096) is None
    assert tstack.supports(tm.config, 64, 100) is None  # any batch: the ragged tile is masked
    assert tstack.supports(tm.config, 1024, B) is None  # the wide kernel (a thread runs several frames)
    assert "block size" in tstack.supports(tm.config, 2048, B)  # the JAX gate refuses it too
    assert "WaveNetConfig" in tstack.supports(object(), 64, B)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the Linear item"):
        backend_for(object())


def test_work_counts_for_the_bound():
    """The flagship at T=64: 13,320 MACs per sample; about 98 KB of state and
    I/O per stream and block."""
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("standard"), seed=0), device="cpu")
    w = tstack.work(tm.config, 64, 4096)
    assert w["macs"] == 13320 * 64 * 4096
    per_stream = (w["bytes"] - 4 * 13800) / 4096
    assert 97_000 < per_stream < 99_000


def _array_macs(I, C, K, n_layers, S=1, conv_out=None, bn=None, l1=True, h1=0, films=(), head=(1, None, 1)):
    """MACs per sample of one layer array, counted by hand: rechannel I*C;
    per layer the conv K*C*conv_out, the mixin S*conv_out, layer1x1 bn*C,
    head1x1 bn*h1, each FiLM site S*rows; the head rechannel K*in*out."""
    conv_out = conv_out or C
    bn = bn or C
    per_layer = K * C * conv_out + S * conv_out + (bn * C if l1 else 0) + bn * h1 + sum(S * r for r in films)
    hk, hin, hout = head
    return I * C + n_layers * per_layer + hk * (hin or bn) * hout


def test_work_counts_the_feature_main_paths():
    """flagship_cond: the flagship (13,320) plus its `small` condition net
    (7,312). flagship_max: gated 16/8 with head1x1 and FiLM at conv_pre
    (2*16), input_mixin_post (2*16), activation_post (8), head1x1_post (2*8);
    blended 8 with FiLM at conv_post (2*16), input_mixin_pre (2*1),
    activation_pre (16), layer1x1_post (2*8) and the k=16 head 8 -> 4; the
    post head 4 -> 5 -> 5 -> 1 with k = 3, 1, 4."""
    from neuralampmodelercore_tpu_torch.tools import agreement

    flagship = _array_macs(1, 16, 3, 10, head=(1, 16, 8)) + _array_macs(16, 8, 3, 10, head=(1, 8, 1))
    small = _array_macs(1, 16, 3, 6, head=(1, 16, 8)) + _array_macs(16, 8, 3, 3, head=(1, 8, 1))
    assert (flagship, small) == (13320, 7312)
    a0 = _array_macs(1, 16, 3, 10, conv_out=16, bn=8, h1=8, films=(32, 32, 8, 16), head=(1, 8, 8))
    a1 = _array_macs(16, 8, 3, 10, conv_out=16, films=(32, 2, 16, 16), head=(16, 8, 4))
    post = 3 * 4 * 5 + 1 * 5 * 5 + 4 * 5 * 1
    assert (a0, a1, post) == (10720, 5940, 105)
    for name, macs in (("flagship_cond", flagship + small), ("flagship_max", a0 + a1 + post)):
        arch, config, seed = agreement.configs()[name]
        tm = tnam.load_model(make_nam(arch, config, seed=seed), device="cpu")
        assert tstack.work(tm.config, 64, 2048)["macs"] == macs * 64 * 2048, name


def test_wrapper_refuses_other_devices_and_bad_shapes():
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("simple"), seed=0), device="cpu")
    ep, st = tstack.prepare(tm.config, tm.params, 16, 4)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tstack.step(tm.config, 16, ep, st, torch.zeros(1, 16, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tstack.launch(ep["layout"], ep["weights"], ep["plan"], st["buf"], torch.zeros(1, 16, 4), 0)
