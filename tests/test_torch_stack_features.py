"""The stack kernel's features (K1b-K1e) in the port against the JAX package:
gating and blending, bottleneck, head1x1, per-channel PReLU, FiLM at every
site, the k>1 head rechannel, the post-stack head, and condition DSPs (a
fused WaveNet chain and an LSTM pre-pass).

On the CPU the port's fused tier runs the kernel's plain version
(ops/cuda/stack.py step_plain); it is held against the JAX package's Pallas
kernel in interpret mode at B=128, as the JAX package's own tests run it
(tests/test_pallas_stack.py:25-29), and against its XLA engine tier, state
carried, within 2e-5 absolute (the JAX package's tier-against-tier
tolerance). The configs are the small feature entries of
neuralampmodelercore_tpu_torch/tools/agreement.py configs(), analogs of those
of tests/test_pallas_stack.py, so the configs held against JAX here are the
ones the CUDA kernel is held against its plain version with on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops.pallas import stack as jstack
from neuralampmodelercore_tpu.tools.generate import make_nam
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools import agreement

B = 128
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    jstack.INTERPRET = True
    yield
    jstack.INTERPRET = False


def _run(config, seed, T, n_blocks, tiers=("pallas", "xla"), batch=B):
    """The port's fused tier and the JAX tiers on the same blocks, state
    carried from a zero state."""
    doc = make_nam("WaveNet", config, seed=seed)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    assert tstack.supports(tm.config, T, batch) is None
    x = (np.random.default_rng(seed).standard_normal((batch, n_blocks * T)) * 0.3).astype(np.float32)
    fe = tnam.StreamEngine(tm, batch=batch, block_size=T, kernel="fused")
    fs = fe.reset(prewarm=False)
    jes = {k: JEngine(jm, batch=batch, block_size=T, kernel=k) for k in tiers}
    jss = {k: e.reset(prewarm=False) for k, e in jes.items()}
    assert all(e.kernel == k for k, e in jes.items())
    before = tstack.launches
    for i in range(n_blocks):
        blk = x[:, i * T : (i + 1) * T]
        yt, fs = fe.process(blk, fs)
        for k, e in jes.items():
            yj, jss[k] = e.process(blk, jss[k])
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{k} block {i}")
    assert tstack.launches == before  # CPU tensors never launch the kernel
    return tm


# The feature configs of tools/agreement.py: the table the card's tests and
# the agreement sweep use. T and block counts follow tests/test_pallas_stack.py.
FEATURES = agreement.configs()


def _config(name):
    arch, config, seed = FEATURES[name]
    assert arch == "WaveNet"
    return config, seed


@pytest.mark.parametrize("name,config,T,n_blocks", [
    ("gated_bottleneck", _config("gated_bottleneck")[0], 16, 8),  # tests/test_pallas_stack.py:90-119
    ("blended_head1x1", _config("blended_head1x1")[0], 8, 10),  # :122-141
    ("post_head", _config("post_head")[0], 16, 8),  # :287-311
    ("depthwise", _config("depthwise")[0], 8, 8),  # :314-334
])
def test_shape_options_match_jax(name, config, T, n_blocks):
    _run(config, _config(name)[1], T, n_blocks)


FILM_SITES_SHIFT = [("conv_pre_film", True), ("conv_post_film", False), ("input_mixin_pre_film", True),
                    ("input_mixin_post_film", True), ("activation_pre_film", False), ("activation_post_film", True)]


@pytest.mark.parametrize("site,shift", FILM_SITES_SHIFT)
def test_film_site_alone_matches_jax(site, shift):
    """Each site alone at T=16 (tests/test_pallas_stack.py:337-364); the
    dilation-32 layer's ring wraps every few blocks, so conv_pre_film's
    filmed history is read back from wrapped slots."""
    config, seed = _config(f"film_{site}")
    assert config["layers"][0][site]["shift"] is shift
    _run(config, seed, T=16, n_blocks=6)


@pytest.mark.parametrize("gating", ["blended", "none"])
def test_layer1x1_post_film_only_when_blended(gating):
    """The reference's quirk (docs/deviations.md item 8): applied under
    blended, ignored under none."""
    _run(*_config(f"layer1x1_post_film_{gating}"), T=16, n_blocks=6)


def test_head1x1_post_film():
    _run(*_config("head1x1_post_film"), T=16, n_blocks=6)


def test_per_channel_prelu_gated():
    _run(*_config("prelu_per_channel"), T=16, n_blocks=6)


def test_k16_head_rechannel_at_T64():
    """The A2 family's k=16 head conv with bias: its 15-frame history is
    carried in the state."""
    _run(*_config("head_k16"), T=64, n_blocks=6)


def test_k16_head_rechannel_refused_at_T8():
    """rf 15 > T=8 is refused, as the JAX kernel refuses it
    (tests/test_pallas_stack.py:181-189): auto takes the torch tier."""
    config, seed = _config("head_k16")
    doc = make_nam("WaveNet", config, seed=seed)
    tm = tnam.load_model(doc, device="cpu")
    assert jstack.supports(jnam.load_model(doc).config, 8, B) is not None
    assert "head rechannel receptive field 15 > T=8" in tstack.supports(tm.config, 8, B)
    assert tnam.StreamEngine(tm, batch=B, block_size=8).kernel == "torch"
    with pytest.raises(ValueError, match="fused kernel does not support"):
        tnam.StreamEngine(tm, batch=B, block_size=8, kernel="fused")


def test_condition_chain_depth2_fused():
    """Two nested WaveNet condition DSPs fuse as prelude nets into the same
    launch (tests/test_pallas_stack.py:216-248): three nets in the plan, no
    pre-pass."""
    tm = _run(*_config("condition_chain_depth2"), T=16, n_blocks=8)
    assert tstack.cond_mode(tm.config, 16) == "fused"
    ep, _ = tstack.prepare(tm.config, tm.params, 16, B)
    assert len(ep["layout"].nets) == 3 and "condition" not in ep


def test_condition_lstm_prepass():
    """An LSTM condition DSP runs as a pre-pass whose output is the kernel's
    second input (tests/test_pallas_stack.py:251-276); on the CPU the
    pre-pass is the LSTM's torch engine tier."""
    tm = _run(*_config("condition_lstm_prepass"), T=16, n_blocks=6)
    assert tstack.cond_mode(tm.config, 16) == "prepass"
    ep, _ = tstack.prepare(tm.config, tm.params, 16, B)
    assert ep["layout"].S_ext == 1 and len(ep["layout"].nets) == 1


@pytest.mark.parametrize("name,prewarm", [("flagship_cond", 5115), ("flagship_max", 4113)])
def test_feature_main_paths_at_full_width(name, prewarm):
    """The two feature main paths of chip_smoke.py at full width, against the
    JAX XLA tier at B=2 and T=64 over 3 blocks."""
    tm = _run(*_config(name), T=64, n_blocks=3, tiers=("xla",), batch=2)
    assert tm.get_prewarm_samples() == prewarm
    assert tstack.supports(tm.config, 64, 2048) is None


def test_agreement_sweep_on_the_cpu(tmp_path):
    """The agreement sweep's machinery with device="cpu" (the fused tier is
    the plain version there): two configs, one JSON each."""
    res = agreement.sweep(["gated_bottleneck", "film_conv_pre_film"], batches=(4,), blocks=3, device="cpu",
                          out=str(tmp_path), log=lambda s: None)
    assert all(r["ok"] and r["B4"]["max_abs_diff"] <= ATOL for r in res.values()), res
    assert sorted(p.name for p in tmp_path.iterdir()) == ["film_conv_pre_film.json", "gated_bottleneck.json"]


def test_kernel_ab_reaches_a_kernel_for_every_sweep_config():
    """tools/kernel_ab.py picks the kernel from the config's architecture;
    for every config of the sweep that is a module with the wrapper
    interface its worker calls."""
    import importlib

    from neuralampmodelercore_tpu_torch.tools import kernel_ab

    compile(kernel_ab.WORKER, "kernel_ab worker", "exec")
    for name, (arch, _, _) in FEATURES.items():
        mod = importlib.import_module("neuralampmodelercore_tpu_torch.ops.cuda." + kernel_ab.KERNELS[arch])
        assert all(callable(getattr(mod, f)) for f in ("supports", "prepare", "step")), name
        assert callable(mod.LIB.compile), name


def test_supports_limits_and_reasons():
    """What the kernel still refuses, each with the limit or the ROADMAP item."""
    def reason(config, T=16):
        return tstack.supports(tnam.load_model(make_nam("WaveNet", config, seed=0), device="cpu").config, T, B)

    layer = agreement.small_layer
    assert "2 * bottleneck" in reason({"layers": [layer(channels=16, bottleneck=65, gated=True)], "head": None})
    assert reason({"layers": [layer(channels=16, bottleneck=17, gated=True)], "head": None}) is None  # wide kernel
    assert reason({"layers": [layer(channels=16, bottleneck=16, gated=True)], "head": None}) is None
    assert "post-stack head conv receptive field 20 > T=16" in reason(
        {"layers": [layer()], "head": {"channels": 2, "out_channels": 1, "kernel_sizes": [21], "activation": "Tanh"}})
    assert reason(_config("head_k16")[0], T=1024) is None  # the wide kernel
    assert "T=2048" in reason(_config("head_k16")[0], T=2048)
