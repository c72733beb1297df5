"""Tests that need the CUDA card: each kernel (stack, stack_wf, stack_wide,
lstm, lstm_wide's tile and group kernels, convnet, convnet_wide, and the
tools' proto_ring and dot_chain) against its plain version on the same CUDA
inputs (the LSTM tile kernel also against the group kernel, exactly; for the stack
kernel, every feature: gating, bottleneck, head1x1, FiLM sites, k>1 head
rechannel, post-stack head, condition chains and the LSTM pre-pass; the
fast-tanh and LUT modes in the stack kernel and in K3; the wavefront kernel
against step_plain_wf, and a stream switching between the two stack
kernels), each main path's choice of its kernel with its exact launch count,
and the agreement sweep.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch. Every test is marked ``cuda`` and skips, inside the
test, when there is no card. On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py imports JAX.) Tolerance 2e-5 absolute,
the JAX package's tier-against-tier tolerance."""

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu_torch.ops import activations as tact
from neuralampmodelercore_tpu_torch.ops.cuda import convnet as tconv
from neuralampmodelercore_tpu_torch.ops.cuda import lstm as tlstm
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools import agreement
from neuralampmodelercore_tpu_torch.tools import microbench_dots as tmbd
from neuralampmodelercore_tpu_torch.tools import proto_ring_kernel as tprk
from neuralampmodelercore_tpu_torch.tools.generate import make_nam, wavenet_preset, with_condition_dsp

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
    assert eng.prewarm_plan()[1] == 0
    assert tstack.launches == before + eng.prewarm_plan()[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(4):
        x = torch.randn((256, 64), generator=gen, device="cuda") * 0.3
        y, s = eng.process(x, s)
        yr, rs = ref.process(x, rs)
        torch.testing.assert_close(y, yr, rtol=0, atol=ATOL)
    assert tstack.launches == before + eng.prewarm_plan()[0] + 4


LSTM_2X16 = {"input_size": 1, "hidden_size": 16, "num_layers": 2}
AMP_CONVNET = {"channels": 16, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512], "batchnorm": True,
               "activation": "Tanh"}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config,T,B,fast",
    [
        ({"input_size": 1, "hidden_size": 3, "num_layers": 1}, 64, 1024, False),
        (LSTM_2X16, 64, 1000, False),
        (LSTM_2X16, 34, 256, False),
        ({"input_size": 1, "hidden_size": 5, "num_layers": 2, "out_channels": 2}, 16, 300, False),
        (LSTM_2X16, 64, 512, True),
        (LSTM_2X16, 64, 32768, False),  # lstm_wide.cu's tile kernel, as at B = 2,048
        # lstm.cu, from LSTM_CU_FROM's batch on: 2 x 16 and 2 x 8 (fast-tanh) at 65,536, 1 x 3 at 32,768.
        (LSTM_2X16, 64, 65536, False),
        ({"input_size": 1, "hidden_size": 8, "num_layers": 2}, 64, 65536, True),
        ({"input_size": 1, "hidden_size": 3, "num_layers": 1}, 34, 32768, False),
    ],
)
def test_lstm_kernel_matches_plain_version(config, T, B, fast):
    _cuda_or_skip()
    tm = tnam.load_model(make_nam("LSTM", config, seed=2))
    ep, sk = tlstm.prepare(tm.config, tm.params, T, B)
    h, c = sk["h"].clone(), sk["c"].clone()
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = tlstm.launches
    if fast:
        tact.enable_fast_tanh()
    try:
        for _ in range(4):
            x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
            yk, sk = tlstm.step(tm.config, T, ep, sk, x)
            yp = tlstm.step_plain(ep["layout"], ep["weights"], h, c, x)
            torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["h"], h, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["c"], c, rtol=0, atol=ATOL)
    finally:
        tact.disable_fast_tanh()
    assert tlstm.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "config,T,B",
    [
        (AMP_CONVNET, 64, 1024),
        (AMP_CONVNET, 16, 1000),
        ({"channels": 8, "dilations": [1, 3, 24, 50], "batchnorm": False, "activation": "SiLU", "groups": 2,
          "in_channels": 2, "out_channels": 2}, 16, 300),
    ],
)
def test_convnet_kernel_matches_plain_version(config, T, B):
    _cuda_or_skip()
    tm = tnam.load_model(make_nam("ConvNet", config, seed=2))
    ep, sk = tconv.prepare(tm.config, tm.params, T, B)
    buf = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = tconv.launches
    for _ in range(12):
        x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
        n = sk["n"]
        yk, sk = tconv.step(tm.config, T, ep, sk, x)
        yp = tconv.step_plain(ep["layout"], ep["weights"], buf, x, n)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
    assert tconv.launches == before + 12


@pytest.mark.cuda
@pytest.mark.parametrize(
    "arch,config,sample_rate,plan",
    [("LSTM", LSTM_2X16, 44100, (344, 34)), ("ConvNet", AMP_CONVNET, 48000, (16, 0))],
)
def test_lstm_and_convnet_main_paths_run_their_kernels(arch, config, sample_rate, plan):
    """auto picks the kernel; prewarm launches it for every full block and
    once for the remainder; the result matches the torch engine tier."""
    _cuda_or_skip()
    mod = tlstm if arch == "LSTM" else tconv
    tm = tnam.load_model(make_nam(arch, config, seed=2, sample_rate=sample_rate))
    eng = tnam.StreamEngine(tm, batch=256, block_size=64)
    ref = tnam.StreamEngine(tm, batch=256, block_size=64, kernel="torch")
    assert eng.kernel == "fused" and ref.kernel == "torch"
    assert eng.prewarm_plan() == plan
    before = mod.launches
    s, rs = eng.reset(), ref.reset()
    prewarm_launches = plan[0] + (1 if plan[1] else 0)
    assert mod.launches == before + prewarm_launches
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(4):
        x = torch.randn((256, 64), generator=gen, device="cuda") * 0.3
        y, s = eng.process(x, s)
        yr, rs = ref.process(x, rs)
        torch.testing.assert_close(y, yr, rtol=0, atol=ATOL)
    assert mod.launches == before + prewarm_launches + 4


def _plain_condition(ep, cstate, x):
    """The pre-pass condition through the condition model's plain version:
    (cond, state') with the state a copy (an LSTM's h and c)."""
    sub_step, sub_ep = ep["condition"]
    assert sub_step is tlstm.step, "the LSTM pre-pass runs K2 on the card"
    h, c = cstate["h"].clone(), cstate["c"].clone()
    return tlstm.step_plain(sub_ep["layout"], sub_ep["weights"], h, c, x), {"h": h, "c": c}


# (config name in tools/agreement.py, T, B): every FiLM site alone at T=16,
# where conv_pre_film's dilation 32 wraps its ring, and each other feature.
FEATURE_CASES = [(f"film_{s}", 16, 300) for s in (
    "conv_pre_film", "conv_post_film", "input_mixin_pre_film", "input_mixin_post_film",
    "activation_pre_film", "activation_post_film")] + [
    ("gated_bottleneck", 16, 300), ("blended_head1x1", 16, 300), ("layer1x1_post_film_blended", 16, 300),
    ("layer1x1_post_film_none", 16, 300), ("head1x1_post_film", 16, 300), ("head_k16", 64, 300),
    ("head_k16", 16, 300), ("post_head", 16, 300), ("condition_chain_depth2", 16, 300),
    ("condition_lstm_prepass", 16, 300), ("prelu_per_channel", 16, 300), ("flagship_max", 64, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,T,B", FEATURE_CASES)
def test_stack_features_kernel_matches_plain_version(name, T, B):
    """State carried over 6 blocks; the LSTM pre-pass launches K2 and the
    stack kernel once per block each."""
    _cuda_or_skip()
    arch, config, seed = agreement.configs()[name]
    tm = tnam.load_model(make_nam(arch, config, seed=seed))
    assert tstack.supports(tm.config, T, B) is None
    ep, sk = tstack.prepare(tm.config, tm.params, T, B)
    buf = sk["buf"].clone()
    cstate = {k: v.clone() for k, v in sk["condition"].items()} if "condition" in sk else None
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = (tstack.launches, tlstm.launches)
    for _ in range(6):
        x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
        n = sk["n"]
        cond = None
        if cstate is not None:
            cond, cstate = _plain_condition(ep, cstate, x)
        yk, sk = tstack.step(tm.config, T, ep, sk, x)
        yp = tstack.step_plain(ep["layout"], ep["weights"], buf, x, n, cond)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
    prepass = name == "condition_lstm_prepass"
    assert (tstack.launches, tlstm.launches) == (before[0] + 6, before[1] + (6 if prepass else 0))


@pytest.mark.cuda
@pytest.mark.parametrize("name,prewarm_blocks", [("flagship_cond", 80), ("flagship_max", 65)])
def test_feature_main_paths_run_the_kernel(name, prewarm_blocks):
    """auto picks the stack kernel for the flagship with a WaveNet condition
    DSP (two nets in one launch) and for the everything-on model; one launch
    per block, and the result matches the torch engine tier."""
    _cuda_or_skip()
    arch, config, seed = agreement.configs()[name]
    tm = tnam.load_model(make_nam(arch, config, seed=seed))
    eng = tnam.StreamEngine(tm, batch=256, block_size=64)
    ref = tnam.StreamEngine(tm, batch=256, block_size=64, kernel="torch")
    assert eng.kernel == "fused" and eng.prewarm_plan() == (prewarm_blocks, 0)
    before = tstack.launches
    s, rs = eng.reset(), ref.reset()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(4):
        x = torch.randn((256, 64), generator=gen, device="cuda") * 0.3
        y, s = eng.process(x, s)
        yr, rs = ref.process(x, rs)
        torch.testing.assert_close(y, yr, rtol=0, atol=ATOL)
    assert tstack.launches == before + prewarm_blocks + 4


@pytest.mark.cuda
def test_agreement_sweep_on_the_card(tmp_path):
    _cuda_or_skip()
    res = agreement.sweep(["flagship_max", "condition_lstm_prepass", "lstm_2x8", "convnet"], batches=(256,),
                          blocks=4, out=str(tmp_path))
    assert all(r["ok"] for r in res.values()), res
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{k}.json" for k in res)


# K1f: the modes inside the stack and ConvNet kernels. (case, architecture,
# config, T, B, fast-tanh, LUTs: (name, min_x, max_x, n_points) each).
MODE_CASES = [
    ("flagship_fast_tanh", "WaveNet", wavenet_preset("standard"), 64, 1024, True, ()),
    ("flagship_tanh_lut", "WaveNet", wavenet_preset("standard"), 16, 1000, False, (("Tanh", -5.0, 5.0, 512),)),
    ("gated_sigmoid_lut", "WaveNet", agreement.configs()["gated_bottleneck"][1], 16, 300, False,
     (("Sigmoid", -2.0, 2.0, 17),)),
    ("depthwise_silu_lut", "WaveNet", agreement.configs()["depthwise"][1], 16, 300, False,
     (("SiLU", -1.5, 1.5, 40),)),
    ("gated_fast_tanh_sigmoid_lut", "WaveNet", agreement.configs()["gated_bottleneck"][1], 16, 300, True,
     (("Sigmoid", -3.0, 3.0, 64),)),
    ("amp_convnet_fast_tanh", "ConvNet", AMP_CONVNET, 64, 1024, True, ()),
    ("amp_convnet_tanh_lut", "ConvNet", AMP_CONVNET, 16, 1000, False, (("Tanh", -1.0, 1.0, 20),)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,arch,config,T,B,fast,luts", MODE_CASES, ids=[c[0] for c in MODE_CASES])
def test_modes_kernel_matches_plain_version(case, arch, config, T, B, fast, luts):
    """fast-tanh and LUT modes inside the stack kernel and K3, against their
    plain versions under the same modes, state carried over 6 blocks."""
    _cuda_or_skip()
    mod = tstack if arch == "WaveNet" else tconv
    tm = tnam.load_model(make_nam(arch, config, seed=2))
    with agreement.modes(fast, luts):
        assert mod.supports(tm.config, T, B) is None
        ep, sk = mod.prepare(tm.config, tm.params, T, B)
        buf = sk["buf"].clone()
        gen = torch.Generator(device="cuda").manual_seed(2)
        before = mod.launches
        for _ in range(6):
            x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
            n = sk["n"]
            yk, sk = mod.step(tm.config, T, ep, sk, x)
            yp = mod.step_plain(ep["layout"], ep["weights"], buf, x, n)
            torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
        assert mod.launches == before + 6


# K1g: the wavefront kernel against step_plain_wf. T=20: sub-tiles of 5
# frames, 25 streams per CTA, so sub-tiles split warps.
WF_CASES = [("flagship", 64, 1024), ("flagship", 16, 1000), ("flagship", 20, 300), ("post_head", 16, 300),
            ("head_k16", 64, 300), ("depthwise", 64, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,T,B", WF_CASES)
def test_wavefront_kernel_matches_plain_version(name, T, B):
    _cuda_or_skip()
    arch, config, seed = agreement.configs()[name]
    tm = tnam.load_model(make_nam(arch, config, seed=seed))
    with agreement.modes(wavefront=True):
        ep, sk = tstack.prepare(tm.config, tm.params, T, B)
        assert ep["layout"].wf is not None
        buf = sk["buf"].clone()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        before = (tstack.launches, tstack.wf_launches)
        for _ in range(6):
            x = torch.randn((1, T, B), generator=gen, device="cuda") * 0.3
            n = sk["n"]
            yk, sk = tstack.step(tm.config, T, ep, sk, x)
            yp = tstack.step_plain_wf(ep["layout"], ep["weights"], buf, x, n)
            torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
        assert (tstack.launches, tstack.wf_launches) == (before[0] + 6, before[1] + 6)


@pytest.mark.cuda
def test_wavefront_switched_between_blocks_on_the_card():
    """A stream whose blocks alternate between the two kernels gives the
    unpacked plain version's output and state."""
    _cuda_or_skip()
    tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("standard"), seed=2))
    T, B = 64, 512
    ep, sk = tstack.prepare(tm.config, tm.params, T, B)
    buf = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(5)
    before = tstack.wf_launches
    try:
        for i in range(6):
            tstack.WAVEFRONT = i % 2 == 0
            x = torch.randn((1, T, B), generator=gen, device="cuda") * 0.3
            n = sk["n"]
            yk, sk = tstack.step(tm.config, T, ep, sk, x)
            yp = tstack.step_plain(ep["layout"], ep["weights"], buf, x, n)
            torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
    finally:
        tstack.WAVEFRONT = False
    assert tstack.wf_launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fast_tanh", "wavefront"])
def test_flagship_fast_tanh_and_wavefront_main_paths(path):
    """auto picks the fused tier with the mode or the flag on; the flagship's
    prewarm and blocks launch the stack kernel (all of them the wavefront
    kernel, with the flag on) and match the torch engine tier."""
    _cuda_or_skip()
    with agreement.modes(fast_tanh=path == "fast_tanh", wavefront=path == "wavefront"):
        tm = tnam.load_model(make_nam("WaveNet", wavenet_preset("standard"), seed=2))
        eng = tnam.StreamEngine(tm, batch=256, block_size=64)
        ref = tnam.StreamEngine(tm, batch=256, block_size=64, kernel="torch")
        assert eng.kernel == "fused" and eng.prewarm_plan() == (64, 0)
        before = (tstack.launches, tstack.wf_launches)
        s, rs = eng.reset(), ref.reset()
        gen = torch.Generator(device="cuda").manual_seed(3)
        for _ in range(4):
            x = torch.randn((256, 64), generator=gen, device="cuda") * 0.3
            y, s = eng.process(x, s)
            yr, rs = ref.process(x, rs)
            torch.testing.assert_close(y, yr, rtol=0, atol=ATOL)
        wf = 68 if path == "wavefront" else 0
        assert (tstack.launches, tstack.wf_launches) == (before[0] + 68, before[1] + wf)


# The wide kernels (csrc/*_wide.cu): (architecture, config, T, B).
WIDE_CASES = {
    "stack_rows48_gated": ("WaveNet", {"layers": [agreement.small_layer(channels=32, bottleneck=24, gated=True)],
                                       "head": None}, 16, 300),
    "stack_large": ("WaveNet", wavenet_preset("large"), 64, 256),
    "stack_flagship_T1024": ("WaveNet", wavenet_preset("standard"), 1024, 64),
    "stack_in8": ("WaveNet", {"in_channels": 8, "layers": [agreement.small_layer(input_size=8, condition_size=8)],
                              "head": None}, 16, 300),
    # Each of these ends on a ragged column tile (T BS not a multiple of a warp's columns) and,
    # but for T = 600, a ragged last CTA (B not a multiple of BS).
    "stack_ragged_B1000_T1": ("WaveNet", {"layers": [agreement.small_layer(channels=48, head_size=1)], "head": None},
                              1, 1000),
    "stack_flagship_T600": ("WaveNet", wavenet_preset("standard"), 600, 300),
    "stack_rows33": ("WaveNet", {"layers": [agreement.small_layer(channels=33, head_size=1, dilations=[1, 4, 128])],
                                 "head": None}, 20, 999),
    "stack_gated_head1x1": ("WaveNet", {"layers": [agreement.small_layer(
        channels=32, bottleneck=24, gated=True, dilations=[1, 8, 100],
        head1x1={"active": True, "out_channels": 6, "groups": 1})], "head": None}, 20, 999),
    "stack_conv_pre_film": ("WaveNet", {"layers": [agreement.small_layer(
        channels=36, dilations=[1, 8, 100], conv_pre_film=agreement.film(),
        conv_post_film=agreement.film(False))], "head": None}, 20, 999),
    "stack_condition_chain": ("WaveNet", with_condition_dsp(
        {"layers": [agreement.small_layer(channels=8, head_size=1)], "head": None},
        make_nam("WaveNet", {"layers": [agreement.small_layer(channels=40, head_size=1)], "head": None}, seed=3)),
        20, 999),
    "lstm_48x2": ("LSTM", {"input_size": 1, "hidden_size": 48, "num_layers": 2}, 34, 300),
    "lstm_8x5": ("LSTM", {"input_size": 1, "hidden_size": 8, "num_layers": 5}, 64, 300),
    "convnet_64": ("ConvNet", {"channels": 64, "dilations": [1, 2, 4, 8, 128], "batchnorm": True,
                               "activation": "Tanh"}, 64, 300),
    "convnet_prelu_per_channel": ("ConvNet", {"channels": 8, "dilations": [1, 2, 4], "batchnorm": True,
                                              "activation": {"type": "PReLU", "negative_slopes": [0.1, 0.2]}}, 16, 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_kernels_match_plain_versions(name):
    """Each wide kernel against its plain version, state carried over 4
    blocks; every block launches the wide kernel."""
    _cuda_or_skip()
    arch, config, T, B = WIDE_CASES[name]
    mod = {"WaveNet": tstack, "LSTM": tlstm, "ConvNet": tconv}[arch]
    tm = tnam.load_model(make_nam(arch, config, seed=2))
    assert mod.supports(tm.config, T, B) is None
    ep, sk = mod.prepare(tm.config, tm.params, T, B)
    ref = {k: v.clone() for k, v in sk.items() if torch.is_tensor(v)}
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = mod.wide_launches
    for _ in range(4):
        x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
        if arch == "LSTM":
            yp = tlstm.step_plain(ep["layout"], ep["weights"], ref["h"], ref["c"], x)
        else:
            yp = mod.step_plain(ep["layout"], ep["weights"], ref["buf"], x, sk["n"] % ep["layout"].wrap)
        yk, sk = mod.step(tm.config, T, ep, sk, x)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        for k, v in ref.items():
            torch.testing.assert_close(sk[k], v, rtol=0, atol=ATOL)
    assert mod.wide_launches == before + 4


def _wide_stack(config, T, B, tile=None):
    tm = tnam.load_model(make_nam("WaveNet", config, seed=2))
    assert tstack.supports(tm.config, T, B) is None
    ep, sk = tstack.prepare(tm.config, tm.params, T, B, **({"wide_tile": tile} if tile else {}))
    assert ep["layout"].wide is not None
    return tm, ep, sk


@pytest.mark.cuda
@pytest.mark.parametrize("tile", sorted(tstack.WIDE_TILES))
def test_stack_wide_every_tile_on_large(tile):
    """Each register tile of csrc/stack_wide.cu (a template instance)
    forced on the LARGE WaveNet at B = 256: within 2e-5 of step_plain over 4
    blocks with state carried, one launch of the wide kernel per block."""
    _cuda_or_skip()
    tm, ep, sk = _wide_stack(wavenet_preset("large"), 64, 256, tile)
    assert ep["layout"].wide.tile == tile
    buf = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(4)
    before = (tstack.launches, tstack.wide_launches)
    for _ in range(4):
        x = torch.randn((1, 64, 256), generator=gen, device="cuda") * 0.3
        yp = tstack.step_plain(ep["layout"], ep["weights"], buf, x, sk["n"] % ep["layout"].wrap)
        yk, sk = tstack.step(tm.config, 64, ep, sk, x)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["buf"], buf, rtol=0, atol=ATOL)
    assert (tstack.launches, tstack.wide_launches) == (before[0] + 4, before[1] + 4)


GUARD_CASES = {
    "large_B256": (wavenet_preset("large"), 64, 256),
    "ragged_B1000_T1": ({"layers": [agreement.small_layer(channels=48, head_size=1)], "head": None}, 1, 1000),
    "flagship_T1024_B64": (wavenet_preset("standard"), 1024, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GUARD_CASES))
def test_stack_wide_writes_nothing_past_the_output_or_the_state(name):
    """The wide stack kernel launched on an output and a state that sit
    between guard bands of a sentinel: over 3 blocks the bands stay as they
    were, and the output and state are those of the wrapper's launch bit
    for bit."""
    _cuda_or_skip()
    config, T, B = GUARD_CASES[name]
    tm, ep, sk = _wide_stack(config, T, B)
    lay, wd = ep["layout"], ep["layout"].wide
    G, SENT = 4096, 12345.0
    n_state, n_y = sk["buf"].numel(), lay.Cout * T * B
    state = torch.full((n_state + 2 * G,), SENT, device="cuda")
    state[G : G + n_state] = sk["buf"]
    y = torch.full((n_y + 2 * G,), SENT, device="cuda")
    lib = tstack.WIDE_LIB.load()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for _ in range(3):
        x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
        n = sk["n"] % lay.wrap
        yk, sk = tstack.step(tm.config, T, ep, sk, x)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nam_stack_wide_step(
            x.data_ptr(), None, y.data_ptr() + 4 * G, state.data_ptr() + 4 * G, ep["weights"].data_ptr(),
            ep["plan"].data_ptr(), T, B, n, lay.BS, wd.rows, wd.srows, int(wd.film_pre), wd.seg_max, wd.tap_max,
            wd.threads, lay.smem_bytes, *wd.tile, stream)
        assert err == 0
        torch.cuda.synchronize()
        assert torch.equal(y[G : G + n_y].view_as(yk), yk)
        assert torch.equal(state[G : G + n_state], sk["buf"])
        for band in (y[:G], y[G + n_y :], state[:G], state[G + n_state :]):
            assert bool((band == SENT).all())


OCCUPANCY_CASES = {
    "large": (wavenet_preset("large"), 64),
    "medium_gated": (agreement.medium_gated(), 64),
    "flagship_T1024": (wavenet_preset("standard"), 1024),
    "rows33": ({"layers": [agreement.small_layer(channels=33, head_size=1)], "head": None}, 64),
    "rows128": ({"layers": [agreement.small_layer(channels=128, head_size=1)], "head": None}, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OCCUPANCY_CASES))
def test_stack_wide_geometry_matches_the_runtime(name):
    """The Python mirror of the wide stack kernel's occupancy holds at every
    tile: the CUDA runtime puts as many CTAs on an SM as
    ``wide_ctas_per_sm`` says (shared memory, threads, registers)."""
    _cuda_or_skip()
    config, T = OCCUPANCY_CASES[name]
    for tile in sorted(tstack.WIDE_TILES):
        lay = _wide_stack(config, T, 2, tile)[1]["layout"]
        assert tstack.wide_ctas_per_sm_runtime(lay) == tstack.wide_ctas_per_sm(lay), (name, tile)


# The tile kernel of csrc/lstm_wide.cu: (config, T, B, fast-tanh mode).
LSTM_48X2 = {"input_size": 1, "hidden_size": 48, "num_layers": 2}
TILE_CASES = {
    "48x2_T64_B2048": (LSTM_48X2, 64, 2048, False),
    "48x2_T34_B2048": (LSTM_48X2, 34, 2048, False),  # the exact prewarm's remainder
    "48x2_T1_B2048": (LSTM_48X2, 1, 2048, False),
    "48x2_T64_B1000": (LSTM_48X2, 64, 1000, False),  # a ragged last tile
    "2x16_T64_B2048": (LSTM_2X16, 64, 2048, False),
    "2x16_T64_B8192": (LSTM_2X16, 64, 8192, False),
    "32x4_T64_B2048": ({"input_size": 1, "hidden_size": 32, "num_layers": 4}, 64, 2048, False),
    "64x1_T64_B2048": ({"input_size": 1, "hidden_size": 64, "num_layers": 1}, 64, 2048, False),
    "in2_48_T64_B2048": ({"input_size": 2, "in_channels": 2, "hidden_size": 48, "num_layers": 1}, 64, 2048, False),
    "48x2_fast_tanh_T64_B2048": (LSTM_48X2, 64, 2048, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_lstm_tile_kernel_matches_plain_and_group_kernel(name):
    """The tile kernel the wrapper picks against step_plain (2e-5) and against
    the group kernel (exactly: the same sums in the same order, each product
    fused into its sum), state carried over 4 blocks; one tile-kernel launch
    a block."""
    _cuda_or_skip()
    config, T, B, fast = TILE_CASES[name]
    tm = tnam.load_model(make_nam("LSTM", config, seed=2))
    ep, sk = tlstm.prepare(tm.config, tm.params, T, B)
    assert ep["layout"].tile > 0, "the wrapper picks the tile kernel"
    epg, sg = tlstm.prepare(tm.config, tm.params, T, B, tile=False)
    assert epg["layout"].tile == 0 and epg["layout"].wide_group > 0
    h, c = sk["h"].clone(), sk["c"].clone()
    gen = torch.Generator(device="cuda").manual_seed(2)
    if fast:
        tact.enable_fast_tanh()
    try:
        for _ in range(4):
            x = torch.randn((tm.config.in_channels, T, B), generator=gen, device="cuda") * 0.3
            before = (tlstm.tile_launches, tlstm.wide_launches)
            yk, sk = tlstm.step(tm.config, T, ep, sk, x)
            assert (tlstm.tile_launches, tlstm.wide_launches) == (before[0] + 1, before[1] + 1)
            yg, sg = tlstm.step(tm.config, T, epg, sg, x)
            assert tlstm.tile_launches == before[0] + 1
            yp = tlstm.step_plain(ep["layout"], ep["weights"], h, c, x)
            torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["h"], h, rtol=0, atol=ATOL)
            torch.testing.assert_close(sk["c"], c, rtol=0, atol=ATOL)
            assert torch.equal(yk, yg) and torch.equal(sk["h"], sg["h"]) and torch.equal(sk["c"], sg["c"])
    finally:
        tact.disable_fast_tanh()


@pytest.mark.cuda
def test_lstm_beyond_the_tile_runs_the_group_kernel():
    """64 x 8's weights (992 KB) do not fit a CTA's shared memory: the group
    kernel runs it, against step_plain, state carried."""
    _cuda_or_skip()
    tm = tnam.load_model(make_nam("LSTM", {"input_size": 1, "hidden_size": 64, "num_layers": 8}, seed=2))
    ep, sk = tlstm.prepare(tm.config, tm.params, 64, 512)
    assert ep["layout"].tile == 0 and ep["layout"].wide_group > 0
    h, c = sk["h"].clone(), sk["c"].clone()
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = (tlstm.tile_launches, tlstm.wide_launches)
    for _ in range(4):
        x = torch.randn((1, 64, 512), generator=gen, device="cuda") * 0.3
        yk, sk = tlstm.step(tm.config, 64, ep, sk, x)
        yp = tlstm.step_plain(ep["layout"], ep["weights"], h, c, x)
        torch.testing.assert_close(yk, yp, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["h"], h, rtol=0, atol=ATOL)
        torch.testing.assert_close(sk["c"], c, rtol=0, atol=ATOL)
    assert (tlstm.tile_launches, tlstm.wide_launches) == (before[0], before[1] + 4)


@pytest.mark.cuda
def test_proto_ring_kernel_matches_plain_version():
    """K4 at the prototype's shapes over n = 0, 1, 2, 3, 5, 7 (the slots
    wrap), state carried: exact on y and on the ring, the ring written in
    place, the slots other than wslot bit-identical, one launch per step."""
    _cuda_or_skip()
    ring0, x0 = tprk.data()
    ring = torch.from_numpy(ring0).cuda()
    ring_plain = ring.clone()
    storage = ring.data_ptr()
    x = torch.from_numpy(x0).cuda()
    for n in (0, 1, 2, 3, 5, 7):
        nt = torch.tensor(n, dtype=torch.int32, device="cuda")
        prev = ring.clone()
        before = tprk.launches
        y = tprk.step(ring, x, nt)
        yp = tprk.step_plain(ring_plain, x, nt)
        torch.cuda.synchronize()
        assert tprk.launches == before + 1
        assert ring.data_ptr() == storage
        assert torch.equal(y, yp) and torch.equal(ring, ring_plain)
        for m in range(tprk.M):
            assert torch.equal(ring[m], prev[m]) == (m != n % tprk.M)
        x = y  # the next step writes other data


DOT_CASES = [("chain", None, "f32"), ("chain", None, "bf16"), ("packed", 4, "f32"), ("packed", 4, "bf16"),
             ("packed", 8, "f32"), ("packed", 8, "bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G,dtype", DOT_CASES)
def test_dot_chain_kernel_matches_plain_version(kind, G, dtype):
    """K5 and K6 at the tool's shapes and scale, N = 65,536 columns (and a
    ragged N = 1,000): one launch per chain. f32: 2e-5 x max|output| for the
    20-step chain, 2e-5 absolute for K6; bf16: 2e-2 x max|output|."""
    _cuda_or_skip()
    x_np, w_np = tmbd.data()["chain" if G is None else f"G{G}"]
    w = torch.from_numpy(w_np).cuda()
    td = tmbd.DTYPES[dtype]
    for N in (x_np.shape[1], 1000):
        x = torch.from_numpy(x_np[:, :N].copy()).cuda()
        before = (tmbd.chain_launches, tmbd.packed_launches)
        if G is None:
            got, want = tmbd.chain(x, w, td), tmbd.chain_plain(x, w, td)
        else:
            got, want = tmbd.packed(x, w, G, td), tmbd.packed_plain(x, w, G, td)
        torch.cuda.synchronize()
        assert (tmbd.chain_launches, tmbd.packed_launches) == (before[0] + (G is None), before[1] + (G is not None))
        assert got.shape == want.shape and torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if dtype == "bf16":
            assert err <= 2e-2 * scale
        elif G is None:
            assert err <= 2e-5 * scale
        else:
            assert err <= 2e-5


F32_CASES = [("chain", None), ("packed", 4), ("packed", 8)]


def _f32_chain(G, N=None, seed=None):
    """A f32 case's operands on the card: the tool's own (N = 65,536), or N
    columns from ``seed`` at the tool's scale."""
    x_np, w_np = tmbd.data()["chain" if G is None else f"G{G}"]
    if seed is not None:
        x_np = (np.random.default_rng(seed).standard_normal((x_np.shape[0], N)) * 0.1).astype(np.float32)
    return torch.from_numpy(x_np).cuda(), torch.from_numpy(w_np).cuda()


def _f32_run(x, w, G):
    return tmbd.chain(x, w, torch.float32) if G is None else tmbd.packed(x, w, G, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G", F32_CASES)
def test_dot_chain_f32_matches_a_float64_chain(kind, G):
    """K5 and K6 in f32 at the tool's shapes against the same chain in
    float64 on the card: within 2e-5 for K6 and 2e-5 x max|output| for K5,
    whose 20 steps shrink the output to about 5e-4."""
    _cuda_or_skip()
    x, w = _f32_chain(G)
    got = _f32_run(x, w, G)
    want = x.double()
    for s in range(w.shape[0]):
        y = torch.tanh(w[s].double() @ want)
        want = torch.cat([y, y, y])
    err = (got.double() - want).abs().max().item()
    assert err <= (2e-5 * want.abs().max().item() if G is None else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 64, 132, 65536 + 4])
def test_dot_chain_f32_ragged_columns(N):
    """K6 at G = 8 (R = 128, 128 columns a CTA) at N = 4 and 64 (below one
    CTA's columns), 132 (one column group past a CTA) and 65,540: within
    2e-5 of the plain version, one launch a call."""
    _cuda_or_skip()
    x, w = _f32_chain(8, N, seed=N)
    before = tmbd.packed_launches
    got = tmbd.packed(x, w, 8)
    want = tmbd.packed_plain(x, w, 8)
    assert tmbd.packed_launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind,G", F32_CASES)
def test_dot_chain_f32_one_launch_and_no_write_past_the_output(kind, G):
    """The whole f32 chain is one kernel launch (the profiler sees one
    kernel on the card), and a call writes its (3R, N) output and nothing
    on either side of it: a guard band of 4,096 floats keeps its values.
    A ragged N = 1,000 and the tool's 65,536."""
    _cuda_or_skip()
    from torch.profiler import ProfilerActivity, profile

    lib = tmbd.LIB.load()
    for N in (1000, 65536):
        x, w = _f32_chain(G, N, seed=N)
        S, R, _ = w.shape
        guard = 4096
        buf = torch.full((x.numel() + 2 * guard,), 7.0, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            err = lib.nam_dot_chain(x.data_ptr(), w.data_ptr(), buf[guard:].data_ptr(), S, R, N, 0,
                                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
        assert err == 0
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "chain_f32" in kernels[0], kernels
        assert (buf[:guard] == 7.0).all() and (buf[guard + x.numel():] == 7.0).all()
        want = tmbd.packed_plain(x, w, G) if G else tmbd.chain_plain(x, w)
        err = (buf[guard:guard + x.numel()].view(x.shape) - want).abs().max().item()
        assert err <= (2e-5 if G else 2e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("R", tmbd.ROWS)
def test_dot_chain_f32_geometry_matches_the_runtime(R):
    """The Python mirror of the f32 kernel's geometry holds: the CUDA
    runtime puts as many CTAs on an SM as ``f32_ctas_per_sm`` says."""
    _cuda_or_skip()
    assert tmbd.ctas_per_sm(R) == tmbd.f32_ctas_per_sm(R)
