"""The wide kernels of the port against the JAX package: what the register
tiles of csrc/stack.cu, lstm.cu and convnet.cu cannot hold, and the JAX
Pallas kernels run.

  - WaveNet (csrc/stack_wide.cu): the reference's LARGE preset (64 then 32
    channels), a gated MEDIUM (2 * 32 conv rows), rows that are not
    multiples of the old tiles (33, 40, 48), a wide net inside a fused
    condition chain, the flagship at T = 600 and 1,024, and 5 and 8 input
    channels;
  - LSTM (csrc/lstm_wide.cu): 48 x 2, 64 x 1, 8 x 5 and 2 inputs x 48;
  - ConvNet (csrc/convnet_wide.cu): 48 and 64 channels, PReLU with a slope
    per channel, and the amp ConvNet at T = 1,024.

Each config is cut to 2-3 layers per array at its own widths. For each: the
port's gate admits it and lays it out for the wide kernel, StreamEngine's
"auto" picks "fused" for a model on the card, and the fused tier (on the
CPU the kernel's plain version, on the wide kernel's layout) matches the
JAX package's XLA engine tier over several blocks with state carried,
within 2e-5 absolute (the JAX package's tier-against-tier tolerance). The
gate-parity grid holds the port's gate to the JAX gates at full depth and
B = 2,048; the refusal tests pin what stays refused and that each reason
names its limit. Within csrc/lstm_wide.cu, the choice between its tile and
group kernels is pinned: the shared-memory byte count, which models the
tile kernel takes, and its tile shape and grid at B = 2,048 and 8,192. The
CUDA kernels themselves are held against their plain versions on the card
by chip_smoke.py (phase 3) and tests/test_torch_cuda.py."""

import copy

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops.pallas import convnet as jconv
from neuralampmodelercore_tpu.ops.pallas import lstm as jlstm
from neuralampmodelercore_tpu.ops.pallas import stack as jstack
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset, with_condition_dsp
from neuralampmodelercore_tpu_torch.ops.cuda import convnet as tconv
from neuralampmodelercore_tpu_torch.ops.cuda import lstm as tlstm
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools import agreement

ATOL = 2e-5
BATCH = 2
KERNELS = {"WaveNet": (tstack, jstack), "LSTM": (tlstm, jlstm), "ConvNet": (tconv, jconv)}


def _layer(**kw):
    base = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                dilations=[1, 4, 100], activation="Tanh", gated=False, head_bias=True)
    base.update(kw)
    return base


def _cut(config, dilations=(1, 32, 1024)):
    """The config with each array cut to the given dilations: its widths
    stay, its depth is 3 layers."""
    config = copy.deepcopy(config)
    for ac in config["layers"]:
        ac["dilations"] = [d for d in dilations if d <= max(ac["dilations"])]
    return config


def _wide_condition_chain():
    """The flagship's second array as a model, conditioned by a 40-channel
    WaveNet: both nets run in one launch of the wide kernel."""
    condition = make_nam("WaveNet", {"layers": [_layer(channels=40, head_size=1)], "head": None}, seed=3)
    return with_condition_dsp({"layers": [_layer(channels=8)], "head": None}, condition)


LARGE, MEDIUM_GATED = wavenet_preset("large"), agreement.medium_gated()
FLAGSHIP = wavenet_preset("standard")
LARGE128 = copy.deepcopy(LARGE)  # the LARGE preset with 128 channels in its first array
LARGE128["layers"][0]["channels"] = LARGE128["layers"][1]["input_size"] = 128
ROWS40 = {"layers": [_layer(channels=40)], "head": None}
IN5 = {"in_channels": 5, "layers": [_layer(input_size=5, condition_size=5, channels=8)], "head": None}
IN8 = {"in_channels": 8, "layers": [_layer(input_size=8, condition_size=8, channels=8,
                                           conv_post_film={"active": True}, input_mixin_pre_film={"active": True})],
       "head": None}
AMP = {"channels": 16, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512], "batchnorm": True, "activation": "Tanh"}
PRELU_CH = {"channels": 16, "dilations": [1, 2, 4, 8], "batchnorm": True,
            "activation": {"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3, 0.4]}}


def _convnet(channels):
    return {"channels": channels, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512], "batchnorm": True,
            "activation": "Tanh"}


def _lstm(hidden, layers, inputs=1):
    return {"input_size": inputs, "in_channels": inputs, "hidden_size": hidden, "num_layers": layers}


# (architecture, config at full depth, T): the JAX gates admit each at B = 2,048.
GATE_GRID = {
    "wavenet_flagship_T64": ("WaveNet", FLAGSHIP, 64),
    "wavenet_flagship_T128": ("WaveNet", FLAGSHIP, 128),
    "wavenet_rows40_T64": ("WaveNet", ROWS40, 64),
    "wavenet_rows40_T128": ("WaveNet", ROWS40, 128),
    "wavenet_large_T64": ("WaveNet", LARGE, 64),
    "wavenet_large_T128": ("WaveNet", LARGE, 128),
    "wavenet_large128_T64": ("WaveNet", LARGE128, 64),
    "wavenet_medium_gated_T64": ("WaveNet", MEDIUM_GATED, 64),
    "wavenet_medium_gated_T128": ("WaveNet", MEDIUM_GATED, 128),
    "wavenet_flagship_T600": ("WaveNet", FLAGSHIP, 600),
    "wavenet_flagship_T1024": ("WaveNet", FLAGSHIP, 1024),
    "wavenet_in5_T64": ("WaveNet", IN5, 64),
    "wavenet_in8_T64": ("WaveNet", IN8, 64),
    "lstm_48x2_T64": ("LSTM", _lstm(48, 2), 64),
    "lstm_64x1_T64": ("LSTM", _lstm(64, 1), 64),
    "lstm_8x5_T64": ("LSTM", _lstm(8, 5), 64),
    "lstm_in2_48_T64": ("LSTM", _lstm(48, 1, inputs=2), 64),
    "convnet_amp_T64": ("ConvNet", AMP, 64),
    "convnet_amp_T1024": ("ConvNet", AMP, 1024),
    "convnet_48_T64": ("ConvNet", _convnet(48), 64),
    "convnet_64_T64": ("ConvNet", _convnet(64), 64),
    "convnet_128_T64": ("ConvNet", _convnet(128), 64),
    "convnet_prelu_per_channel_T64": ("ConvNet", PRELU_CH, 64),
}


@pytest.mark.parametrize("name", sorted(GATE_GRID))
def test_gate_parity_with_the_jax_kernels(name):
    """Where the JAX package runs a config on its Pallas kernel at B = 2,048,
    the port runs it on a hand-written kernel too."""
    arch, config, T = GATE_GRID[name]
    doc = make_nam(arch, config, seed=0)
    tmod, jmod = KERNELS[arch]
    assert jmod.supports(jnam.load_model(doc).config, T, 2048) is None
    assert tmod.supports(tnam.load_model(doc, device="cpu").config, T, 2048) is None


def _auto_kernel(tm, T, batch):
    """The tier StreamEngine(kernel="auto") picks for this model on the card:
    the decision reads the model's device; the engine is built on the CPU
    params and thrown away."""
    device = tm.device
    tm.device = torch.device("cuda")
    try:
        return tnam.StreamEngine(tm, batch=batch, block_size=T).kernel
    finally:
        tm.device = device


def _wide_layout(arch, tm, T):
    """Whether the port lays the model out for its wide kernel at T."""
    tmod = KERNELS[arch][0]
    ep, _ = tmod.prepare(tm.config, tm.params, T, BATCH)
    layout = ep["layout"]
    return {"WaveNet": lambda: layout.wide is not None, "LSTM": lambda: layout.wide_group > 0,
            "ConvNet": lambda: layout.wide_threads > 0}[arch]()


def _against_jax(arch, config, T, n_blocks, seed=5, prewarm=True):
    """Gate, auto's pick, the wide layout, then the fused tier against the
    JAX XLA engine tier over n_blocks with state carried."""
    # An LSTM's 0.5 s prewarm at 496 Hz is 248 samples: 15 blocks of 16 and 8.
    doc = make_nam(arch, config, seed=seed, **({"sample_rate": 496} if arch == "LSTM" else {}))
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    tmod = KERNELS[arch][0]
    assert tmod.supports(tm.config, T, 2048) is None
    assert tmod.supports(tm.config, T, BATCH) is None
    assert _auto_kernel(tm, T, BATCH) == "fused"
    assert _wide_layout(arch, tm, T)
    je = JEngine(jm, batch=BATCH, block_size=T, kernel="xla")
    te = tnam.StreamEngine(tm, batch=BATCH, block_size=T, kernel="fused")
    js, ts = je.reset(prewarm=prewarm), te.reset(prewarm=prewarm)
    rng = np.random.default_rng(seed)
    before = tmod.launches
    for i in range(n_blocks):
        blk = (rng.standard_normal((BATCH, T, tm.num_input_channels)) * 0.3).astype(np.float32)
        yj, js = je.process(blk, js)
        yt, ts = te.process(blk, ts)
        assert torch.isfinite(yt).all()
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{arch} block {i}")
    assert tmod.launches == before  # CPU tensors never launch a kernel
    return tm


# (config, T, blocks): each cut to 2-3 layers per array at its own widths.
WAVENETS = {
    "large_T64": (_cut(LARGE), 64, 4),
    "large_T128": (_cut(LARGE), 128, 3),
    "medium_gated_T64": (_cut(MEDIUM_GATED, (1, 8, 512)), 64, 4),
    "rows33": ({"layers": [_layer(channels=33)], "head": None}, 16, 6),
    "rows40_blended_head1x1": ({"layers": [_layer(channels=40, bottleneck=20, gating_mode="blended",
                                                  head1x1={"active": True, "out_channels": 6, "groups": 1})],
                                "head": None}, 16, 6),
    "rows48_gated_bottleneck": ({"layers": [_layer(channels=32, bottleneck=24, gated=True)], "head": None}, 16, 6),
    "wide_condition_chain": (_wide_condition_chain(), 16, 6),
    "flagship_T600": (FLAGSHIP, 600, 3),
    "flagship_T1024": (FLAGSHIP, 1024, 3),
    "in5": (IN5, 16, 6),
    "in8_film": (IN8, 16, 6),
}


@pytest.mark.parametrize("name", sorted(WAVENETS))
def test_wide_wavenet_matches_jax(name):
    config, T, n = WAVENETS[name]
    tm = _against_jax("WaveNet", config, T, n, prewarm=False)
    if name == "wide_condition_chain":
        assert tstack.cond_mode(tm.config, T) == "fused"
        ep, _ = tstack.prepare(tm.config, tm.params, T, BATCH)
        assert len(ep["layout"].nets) == 2


LSTMS = {
    "48x2": _lstm(48, 2),
    "64x1": _lstm(64, 1),
    "8x5": _lstm(8, 5),
    "in2_48": _lstm(48, 1, inputs=2),
}


@pytest.mark.parametrize("name", sorted(LSTMS))
def test_wide_lstm_matches_jax_with_exact_prewarm(name):
    """The exact recurrent prewarm (15 blocks of 16 and an 8-sample
    remainder) runs through the wide kernel's step too."""
    tm = _against_jax("LSTM", LSTMS[name], 16, 4)
    assert tnam.StreamEngine(tm, batch=BATCH, block_size=16, kernel="fused").prewarm_plan() == (15, 8)


CONVNETS = {
    "c48": (_convnet(48), 16, 6),
    "c64": (_convnet(64), 16, 6),
    "prelu_per_channel": (PRELU_CH, 16, 6),
    "amp_T1024": (AMP, 1024, 3),
}


@pytest.mark.parametrize("name", sorted(CONVNETS))
def test_wide_convnet_matches_jax(name):
    config, T, n = CONVNETS[name]
    _against_jax("ConvNet", config, T, n)


def test_register_tile_kernels_keep_what_they_serve():
    """WaveNets and ConvNets within the old limits keep csrc/stack.cu and
    convnet.cu, with their old layouts. An LSTM both LSTM kernels run takes
    lstm.cu, with its old layout, where h of every layer is at most 32
    floats and the batch reaches LSTM_CU_FROM of its padded hidden width,
    else the wide kernel's tile kernel (PERF.md, ``lstm_tiles --sources``:
    on 2 x 16 the tile kernel is 5.6x faster at B = 2,048 and 1.4x at
    32,768; lstm.cu is 1.15x faster at 65,536)."""
    for arch, config, T in (("WaveNet", FLAGSHIP, 64), ("WaveNet", FLAGSHIP, 512), ("ConvNet", AMP, 64),
                            ("ConvNet", AMP, 512)):
        tm = tnam.load_model(make_nam(arch, config, seed=0), device="cpu")
        assert not _wide_layout(arch, tm, T), (arch, T)
    for (hidden, layers), batch in (((3, 1), 32768), ((8, 4), 65536), ((16, 2), 65536)):
        tm = tnam.load_model(make_nam("LSTM", _lstm(hidden, layers), seed=0), device="cpu")
        assert tlstm.prepare(tm.config, tm.params, 64, batch)[0]["layout"].wide_group == 0, (hidden, layers)
    for (hidden, layers), batch, wide in ((((16, 2), 2, True), ((16, 2), 2048, True), ((16, 2), 16384, True),
                                           ((16, 2), 32768, True), ((16, 2), 65535, True), ((16, 2), 65536, False),
                                           ((16, 2), 1 << 20, False), ((16, 1), 65536, False), ((12, 2), 65536, False),
                                           ((32, 4), 8192, True), ((32, 4), 8193, True), ((32, 4), 1 << 20, True),
                                           ((32, 1), 1 << 20, True), ((24, 2), 1 << 20, True), ((16, 3), 1 << 20, True),
                                           ((16, 4), 1 << 20, True),
                                           ((3, 1), 2, True), ((3, 1), 32767, True), ((3, 1), 32768, False),
                                           ((4, 2), 32768, False), ((4, 8), 32768, True), ((5, 2), 32768, True),
                                           ((5, 2), 65536, False), ((8, 2), 2048, True), ((8, 2), 1 << 20, False),
                                           ((8, 4), 2, True), ((8, 4), 65536, False), ((48, 2), 1 << 20, True),
                                           ((8, 5), 1 << 20, True))):
        cfg = tnam.load_model(make_nam("LSTM", _lstm(hidden, layers), seed=0), device="cpu").config
        assert tlstm._is_wide(cfg, batch) == wide, (hidden, layers, batch)


# (architecture, config, T, what the reason names): beyond the wide kernels.
REFUSED = {
    "wavenet_rows129": ("WaveNet", {"layers": [_layer(channels=129)], "head": None}, 16, "more than 128 channels"),
    "wavenet_gated_rows130": ("WaveNet", {"layers": [_layer(channels=65, gated=True)], "head": None}, 16,
                              "2 * bottleneck rows"),
    "wavenet_in9": ("WaveNet", {"in_channels": 9, "layers": [_layer(input_size=9, condition_size=9)], "head": None},
                    16, "in_channels 9 > 8"),
    "wavenet_flagship_T2048": ("WaveNet", FLAGSHIP, 2048, "T=2048 outside 1..1024"),
    "wavenet_rows32_T1024": ("WaveNet", {"layers": [_layer(channels=32)], "head": None}, 1024,
                             "shared memory"),
    "lstm_hidden65": ("LSTM", _lstm(65, 1), 16, "hidden_size 65 > 64"),
    "lstm_layers9": ("LSTM", _lstm(4, 9), 16, "9 layers > 8"),
    "lstm_in9": ("LSTM", _lstm(4, 1, inputs=9), 16, "in_channels 9 > 8"),
    "convnet_129": ("ConvNet", {"channels": 129, "dilations": [1], "batchnorm": False, "activation": "Tanh"}, 16,
                    "more than 128 channels"),
    "convnet_amp_T2048": ("ConvNet", AMP, 2048, "T=2048 outside 1..1024"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_supports_refuses_beyond_the_wide_kernels(name):
    """What stays refused names its limit; auto takes the torch tier and
    fused raises. A block above the JAX gate's is refused by both."""
    arch, config, T, why = REFUSED[name]
    doc = make_nam(arch, config, seed=0)
    tm = tnam.load_model(doc, device="cpu")
    tmod, jmod = KERNELS[arch]
    reason = tmod.supports(tm.config, T, 4)
    assert reason is not None and why in reason, reason
    assert _auto_kernel(tm, T, 4) == "torch"
    with pytest.raises(ValueError, match="fused kernel does not support"):
        tnam.StreamEngine(tm, batch=4, block_size=T, kernel="fused")
    if "T2048" in name:
        assert jmod.supports(jnam.load_model(doc).config, T, 2048) is not None


# csrc/lstm_wide.cu's two kernels: the tile kernel (the weights and a tile of
# S streams in a CTA's shared memory) runs what fits, the group kernel the rest.
TILE_FITS = {"2x16": _lstm(16, 2), "48x2": _lstm(48, 2), "64x1": _lstm(64, 1), "32x4": _lstm(32, 4),
             "8x5": _lstm(8, 5), "in2_48": _lstm(48, 1, inputs=2)}


def _lstm_cfg(config):
    return tnam.load_model(make_nam("LSTM", config, seed=0), device="cpu").config


def test_lstm_tile_shared_memory_bytes():
    """48 x 2: layer 0 is 50 x 48 float4s, layer 1 97 x 48, the head 49
    floats: 113,092 bytes, rounded up to a float4, then a tile's h (2, L, H,
    S), c (L, H, S) and input (2, Cin, S)."""
    cfg = _lstm_cfg(_lstm(48, 2))
    assert 4 * tlstm._n_wide(cfg) == 50 * 48 * 16 + 97 * 48 * 16 + 49 * 4 == 113092
    assert tlstm._tile_smem_bytes(cfg, 16) == 113104 + 16 * (3 * 2 * 48 + 2 * 1) * 4 == 131664
    # 2 inputs x 16 x 2: 3,345 floats of weights (19 + 33 rows of 16 float4s,
    # the head 17) rounded up to 3,348, and S = 8.
    cfg = _lstm_cfg(_lstm(16, 2, inputs=2))
    assert tlstm._tile_smem_bytes(cfg, 8) == 4 * 3348 + 4 * 8 * (3 * 2 * 16 + 2 * 2) == 16592
    # 64 x 8: 992,516 bytes of weights, beyond any CTA's shared memory.
    cfg = _lstm_cfg(_lstm(64, 8))
    assert 4 * tlstm._n_wide(cfg) == 66 * 64 * 16 + 7 * 129 * 64 * 16 + 65 * 4 == 992516
    assert tlstm._tile(cfg, 2048) is None


@pytest.mark.parametrize("hidden,layers,inputs", [(1, 1, 1), (8, 4, 1), (9, 1, 1), (16, 2, 1), (32, 4, 1),
                                                   (32, 4, 4), (24, 3, 2)])
def test_lstm_models_lstm_cu_runs_fit_the_tile_kernel(hidden, layers, inputs):
    """Every LSTM that csrc/lstm.cu can run (up to its limits, 32 units, 4
    layers, 4 inputs) fits lstm_wide.cu's tile kernel at every batch, so
    where the wrapper sends it to lstm_wide.cu the tile kernel (not the
    group kernel) runs it; lstm.cu runs it on request."""
    config = _lstm(hidden, layers, inputs)
    cfg = _lstm_cfg(config)
    tm = tnam.load_model(make_nam("LSTM", config, seed=0), device="cpu")
    assert tlstm._lstm_cu_runs(cfg)
    for batch in (1, 2048, 32768, 65536, 1 << 20):
        assert tlstm._tile(cfg, batch) is not None, batch
    assert tlstm.prepare(cfg, tm.params, 64, 2048)[0]["layout"].tile > 0
    assert tlstm.prepare(cfg, tm.params, 64, 65536, wide=True)[0]["layout"].tile > 0
    assert tlstm.prepare(cfg, tm.params, 64, 2048, wide=False)[0]["layout"].wide_group == 0


@pytest.mark.parametrize("name", sorted(TILE_FITS))
def test_lstm_tile_kernel_picked_where_it_fits(name):
    """Every LSTM the wrapper sends to lstm_wide.cu at B = 2,048 whose
    weights and tile fit runs the tile kernel (the group kernel on request)."""
    cfg = _lstm_cfg(TILE_FITS[name])
    tm = tnam.load_model(make_nam("LSTM", TILE_FITS[name], seed=0), device="cpu")
    assert tlstm._is_wide(cfg, 2048)
    ep, _ = tlstm.prepare(cfg, tm.params, 64, 2048)
    S, spt = ep["layout"].tile, ep["layout"].tile_spt
    assert (S, spt) == tlstm._tile(cfg, 2048) and S % spt == 0 and ep["layout"].wide_group > 0
    assert cfg.hidden_size * S // spt <= tlstm.TILE_MAX_THREADS
    assert tlstm._tile_smem_bytes(cfg, S) <= tlstm.SMEM_LIMIT
    group = tlstm.prepare(cfg, tm.params, 64, 2048, tile=False)[0]["layout"]
    assert (group.tile, group.wide_group) == (0, ep["layout"].wide_group)


def test_lstm_group_kernel_runs_what_the_tile_cannot_hold():
    tm = tnam.load_model(make_nam("LSTM", _lstm(64, 8), seed=0), device="cpu")
    layout = tlstm.prepare(tm.config, tm.params, 64, 2048)[0]["layout"]
    assert layout.tile == 0 and layout.wide_group == 32
    with pytest.raises(ValueError, match="tile kernel cannot run"):
        tlstm.prepare(tm.config, tm.params, 64, 2048, tile=(1, 1))


@pytest.mark.parametrize("name,batch,tile,grid", [
    ("48x2", 2048, (16, 2), 128), ("48x2", 8192, (32, 4), 256),
    ("2x16", 2048, (8, 1), 256), ("2x16", 8192, (16, 2), 512),
])
def test_lstm_tile_shape_and_grid(name, batch, tile, grid):
    """S and SPT: the largest SPT that leaves every SM 256 threads of the
    batch, then the smallest S with 128 threads a CTA whose CTAs run in one
    wave (48 x 2 holds one CTA an SM: 131,664 bytes at S = 16); at 48 x 2,
    B = 8,192 none does, and the largest tile of 384 threads runs in two."""
    cfg = _lstm_cfg(TILE_FITS[name])
    assert tlstm._tile(cfg, batch) == tile
    assert -(-batch // tile[0]) == grid


def test_lstm_tiles_tool_needs_a_card(monkeypatch, capsys):
    """The tile sweep and the source comparison measure the card only:
    without one each exits 2 and prints no result."""
    from neuralampmodelercore_tpu_torch.tools import lstm_tiles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lstm_tiles.main(["--config", "lstm_48x2", "--batch", "2048"]) == 2
    assert lstm_tiles.main(["--sources", "16x2", "--batch", "65536"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and captured.err.count("needs a CUDA card") == 2


# csrc/stack_wide.cu's launch geometry, as ops/cuda/stack.py mirrors it. Per
# config: (config, T, buffer rows, streams a CTA (BS), shared bytes, the tile
# the wrapper picks, threads at that tile, CTAs an SM, the slices (F, A, B)
# of RT = 8 rows each array's first layer computes). Shared bytes are
# 4 * (T BS (3 rows + 1 condition row) + the staged segment + the staged taps
# (K-1) C T BS), each staged where it fits; CTAs an SM 233,472 //
# (bytes + 1,024) where shared memory binds. The pick is 8 x 2 where the
# taps are staged, else 8 x 4; a warp takes one slice and 32 FT columns.
WIDE_GEOMETRY = {
    # 64 then 32 channels; segment 3*64*64 + 64 + 64 + 64*64 + 64 + 2*64 = 16,704 floats,
    # taps 2*64*128 = 16,384: 4 * (64*2*193 + 16,704 + 16,384) = 231,168. A and B:
    # 64 rows = 8 slices x 2 warps of 64 columns = 16 warps.
    "large": (LARGE, 64, 64, 2, 231168, (8, 2), 512, 1, [(0, 8, 8), (0, 4, 4)]),
    # Gated 2 x 32 conv rows (CP 64): segment 3*32*64 + 64 + 64 + 64*64 + 64 + 2*64 = 10,560,
    # taps 2*32*128 = 8,192: 4 * (64*2*193 + 10,560 + 8,192) = 173,824. A: 32 activation
    # rows = 8 gated slices of 4 + 4; B: max(32 channels, 32 head rows) = 4 slices, not
    # CP = 64's 8.
    "medium_gated": (MEDIUM_GATED, 64, 64, 2, 173824, (8, 2), 512, 1, [(0, 8, 4), (0, 4, 2)]),
    # 16 then 8 channels (both padded to 16 rows): one stream, 1,024 columns;
    # segment 3*16*16 + 16 + 16 + 16*16 + 16 + 2*16 = 1,104; 4 * (1024*49 + 1,104) =
    # 205,120, no room for the 32,768 floats of taps, so 8 x 4. The 8-channel array runs
    # one slice of 8 rows, not a 16-row slice half padding. A of array 0: 2 slices x 8
    # warps of 128 columns, on the instance's 256 threads.
    "flagship_T1024": (FLAGSHIP, 1024, 16, 1, 205120, (8, 4), 256, 1, [(0, 2, 2), (0, 1, 1)]),
    # 33 channels: 48 rows; segment 3*33*48 + 48 + 48 + 48*48 + 48 + 2*48 = 7,296, taps
    # 2*33*128 = 8,448: 4 * (64*2*145 + 7,296 + 8,448) = 137,216. 5 slices x 2 warps.
    "rows33": ({"layers": [_layer(channels=33)], "head": None}, 64, 48, 2, 137216, (8, 2), 320, 1, [(0, 5, 5)]),
    # 128 channels: the 66,176-float segment does not fit beside one stream's
    # buffers, so it is read from device memory; the taps fit:
    # 4 * (64*1*385 + 2*128*64) = 164,096. 16 slices over 64 columns = 16 warps.
    "rows128": ({"layers": [_layer(channels=128)], "head": None}, 64, 128, 1, 164096, (8, 2), 512, 1, [(0, 16, 16)]),
}


def _wide_stack_layout(config, T, tile=None):
    tm = tnam.load_model(make_nam("WaveNet", config, seed=0), device="cpu")
    return tm, tstack.prepare(tm.config, tm.params, T, BATCH, **({"wide_tile": tile} if tile else {}))[0]["layout"]


@pytest.mark.parametrize("name", sorted(WIDE_GEOMETRY))
def test_stack_wide_geometry(name):
    """Buffers, streams a CTA, shared bytes, the tile the wrapper picks, its
    threads, CTAs an SM and each phase's slices and items of the wide stack
    kernel against the values worked out by hand (above)."""
    config, T, rows, BS, smem, tile, threads, ctas, slices = WIDE_GEOMETRY[name]
    tm, lay = _wide_stack_layout(config, T)
    wd = lay.wide
    assert (wd.rows, lay.BS, lay.smem_bytes, wd.tile, wd.threads) == (rows, BS, smem, tile, threads)
    assert (wd.tap_max > 0) == (tile == (8, 2))
    assert tstack.wide_ctas_per_sm(lay) == ctas
    arrays = tm.config.layer_arrays
    assert [tstack._wide_slices(ac, 0, 8) for ac in arrays] == slices
    # A warp takes one slice and 32 FT columns.
    for ac in arrays:
        for n in tstack._wide_slices(ac, 0, 8)[1:]:
            assert tstack._wide_items(n, T * BS, tile[1]) == -(-T * BS // (32 * tile[1])) * n * 32
    assert wd.threads == min(tstack.WIDE_TILES[tile], max(
        tstack._wide_items(n, T * BS, tile[1]) for ac in arrays for n in tstack._wide_slices(ac, 0, 8) if n))


def test_stack_wide_gated_phase_b_takes_the_channels_not_the_padded_rows():
    """Gated MEDIUM's first array pads its conv to CP = 64 rows; phase B
    produces only layer1x1's 32 channels and the head's 32 rows: 4 slices of
    8 (not CP = 64's 8 of which half were thrown away), and both A and B
    sum over the 32 activation rows."""
    tm, lay = _wide_stack_layout(MEDIUM_GATED, 64)
    ac, a = tm.config.layer_arrays[0], lay.arrays[0]
    assert (a.CP, a.C, a.BN, a.HI) == (64, 32, 32, 32)
    assert tstack._wide_slices(ac, 0, 8)[2] * 8 == a.C < a.CP
    plan = tstack._pack_plan(lay)
    first = tstack.P_HEADER + tstack.NF * len(lay.nets)
    assert plan[first + 9] == a.BN  # the kernel's A_BN field


@pytest.mark.parametrize("tile", sorted(tstack.WIDE_TILES))
def test_stack_wide_tile_forced(tile):
    """``prepare(..., wide_tile=...)`` forces each instance; its threads stay
    within the instance's; an unknown tile raises."""
    _, lay = _wide_stack_layout(LARGE, 64, tile)
    assert lay.wide.tile == tile and lay.wide.threads <= tstack.WIDE_TILES[tile]
    assert lay.wide.threads == min(tstack.WIDE_TILES[tile], tstack._wide_items(8, 128, tile[1]))
    with pytest.raises(ValueError, match="tiles are"):
        _wide_stack_layout(LARGE, 64, (8, 8))


def test_convnet_wide_layout_unchanged():
    """The ConvNet's wide kernel shares WIDE_RW, WIDE_THREADS and wide_fit
    with the stack wrapper; the stack kernel's new geometry leaves its
    layout alone: 64 channels at T = 64 take BS = 2, 512 threads and
    4 * (2 * 64*64*2 + 8,320) = 98,816 bytes; per-channel PReLU at 16
    channels BS = 8, 512 threads and 4 * (2 * 16*64*8 + 544) = 67,712."""
    for config, BS, threads, smem in ((_convnet(64), 2, 512, 98816), (PRELU_CH, 8, 512, 67712)):
        tm = tnam.load_model(make_nam("ConvNet", config, seed=0), device="cpu")
        lay = tconv.prepare(tm.config, tm.params, 64, 2048)[0]["layout"]
        assert (lay.BS, lay.wide_threads, lay.smem_bytes) == (BS, threads, smem)
