"""The global fast-tanh and LUT activation modes inside the port's stack and
ConvNet kernels (K1f), against the JAX package.

Each mode is switched on in both packages before either loads or builds
anything (the JAX kernels read it when they are traced) and off again in
``finally``. On the CPU the port's fused tier runs each kernel's plain
version, which resolves every activation through
``activations.kernel_code`` at prepare exactly as the CUDA kernels do; it is
held against the JAX package's Pallas kernel in interpret mode at B=128 (as
the JAX package's own tests run it, tests/test_pallas_stack.py:25-29) and
against its XLA engine tier, state carried, within 2e-5 absolute (the JAX
package's tier-against-tier tolerance). Also here: the resolved-code table
against the JAX ``activations.apply`` precedence, and the ``loadmodel`` and
``benchmodel`` entry points of the port on the CPU."""

import contextlib
import json
import re

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops import activations as jact
from neuralampmodelercore_tpu.ops.pallas import convnet as jconv
from neuralampmodelercore_tpu.ops.pallas import stack as jstack
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset
from neuralampmodelercore_tpu_torch.ops import activations as tact
from neuralampmodelercore_tpu_torch.ops.cuda import convnet as tconv
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools import agreement

B = 128
ATOL = 2e-5
LUT_NAMES = ("Tanh", "Sigmoid", "SiLU")


@contextlib.contextmanager
def modes(fast_tanh=False, luts=()):
    """Switch the global modes on in the JAX package and in the port, and
    off again on exit. ``luts``: (name, min_x, max_x, n_points) each."""
    try:
        for mod in (jact, tact):
            if fast_tanh:
                mod.enable_fast_tanh()
            for lut in luts:
                mod.enable_lut(*lut)
        yield
    finally:
        for mod in (jact, tact):
            mod.disable_fast_tanh()
            for name in LUT_NAMES:
                mod.disable_lut(name)


@pytest.fixture(autouse=True)
def _interpret_mode():
    jstack.INTERPRET = jconv.INTERPRET = True
    yield
    jstack.INTERPRET = jconv.INTERPRET = False


def run_stack(config, seed, T, n_blocks, tiers=("pallas", "xla")):
    """The port's fused tier and the JAX tiers on the same blocks from a zero
    state; returns the port's outputs."""
    doc = make_nam("WaveNet", config, seed=seed)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    assert tstack.supports(tm.config, T, B) is None
    x = (np.random.default_rng(seed).standard_normal((B, n_blocks * T)) * 0.3).astype(np.float32)
    fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    fs = fe.reset(prewarm=False)
    jes = {k: JEngine(jm, batch=B, block_size=T, kernel=k) for k in tiers}
    jss = {k: e.reset(prewarm=False) for k, e in jes.items()}
    ys = []
    for i in range(n_blocks):
        blk = x[:, i * T : (i + 1) * T]
        yt, fs = fe.process(blk, fs)
        ys.append(yt)
        for k, e in jes.items():
            yj, jss[k] = e.process(blk, jss[k])
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{k} block {i}")
    return torch.cat(ys, dim=1), fe


def _exact(config, seed, T, n_blocks):
    """The port's fused tier with both modes off (for the 'mode is on' check)."""
    tm = tnam.load_model(make_nam("WaveNet", config, seed=seed), device="cpu")
    x = (np.random.default_rng(seed).standard_normal((B, n_blocks * T)) * 0.3).astype(np.float32)
    fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    fs = fe.reset(prewarm=False)
    ys = []
    for i in range(n_blocks):
        y, fs = fe.process(x[:, i * T : (i + 1) * T], fs)
        ys.append(y)
    return torch.cat(ys, dim=1)


SPLICE = {"layers": [dict(input_size=1, condition_size=1, channels=8, head_size=1, kernel_size=3,
                          dilations=[3, 12, 28, 52], activation="Tanh", gated=False, head_bias=True)], "head": None}

# (config, seed, T, blocks, fast-tanh, LUTs). A narrow LUT range clamps part
# of the activations' inputs, so the edge case at max_x runs too.
STACK_MODES = {
    "fast_tanh": (SPLICE, 7, 16, 6, True, ()),
    "tanh_lut": (SPLICE, 7, 16, 6, False, (("Tanh", -1.0, 1.0, 33),)),
    "tanh_lut_flagship": (wavenet_preset("standard"), 3, 16, 2, False, (("Tanh", -5.0, 5.0, 512),)),
    "sigmoid_lut_gated": (*agreement.configs()["gated_bottleneck"][1:], 16, 6, False, (("Sigmoid", -2.0, 2.0, 17),)),
    "silu_lut_depthwise": (*agreement.configs()["depthwise"][1:], 8, 6, False, (("SiLU", -1.5, 1.5, 40),)),
    "fast_tanh_and_sigmoid_lut": (*agreement.configs()["gated_bottleneck"][1:], 16, 6, True,
                                  (("Sigmoid", -3.0, 3.0, 64),)),
}


@pytest.mark.parametrize("name", sorted(STACK_MODES))
def test_stack_kernel_modes_match_jax(name):
    """fast-tanh, a Tanh LUT (also the flagship under -5..5 with 512 points),
    a Sigmoid LUT on a gated layer (the gate's secondary activation), a SiLU
    LUT on the depthwise SiLU layers, and fast-tanh with a Sigmoid LUT: the
    port's fused tier against the JAX Pallas kernel and XLA tier; the mode
    changes the output."""
    config, seed, T, n_blocks, fast, luts = STACK_MODES[name]
    with modes(fast, luts):
        y, fe = run_stack(config, seed, T, n_blocks, tiers=("xla",) if name == "tanh_lut_flagship" else
                          ("pallas", "xla"))
        assert fe.params["layout"].modes == tact.modes() != (False, ())
    assert (y - _exact(config, seed, T, n_blocks)).abs().max() > 1e-6


def test_stack_flagship_tanh_lut_against_pallas():
    """The flagship under a Tanh LUT at T=16 (tests/test_pallas_stack.py:398)
    against the JAX Pallas kernel itself."""
    with modes(luts=(("Tanh", -5.0, 5.0, 512),)):
        run_stack(wavenet_preset("standard"), 3, T=16, n_blocks=1, tiers=("pallas",))


AMP = {"channels": 16, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512], "batchnorm": True,
       "activation": "Tanh"}


@pytest.mark.parametrize("fast,luts", [(True, ()), (False, (("Tanh", -1.0, 1.0, 20),))],
                         ids=["fast_tanh", "tanh_lut"])
def test_convnet_kernel_modes_match_jax(fast, luts):
    """The amp ConvNet under fast-tanh and under a Tanh LUT: the port's fused
    tier against the JAX Pallas kernel and XLA tier at T=64."""
    doc = make_nam("ConvNet", AMP, seed=7)
    T, n_blocks = 64, 2
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, n_blocks * T)) * 0.4).astype(np.float32)
    with modes(fast, luts):
        jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
        assert tconv.supports(tm.config, T, B) is None
        fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
        assert fe.params["layout"].act_code == (tact.KERNEL_CODES["Fasttanh"] if fast else tact.LUT_CODES["Tanh"])
        fs = fe.reset(prewarm=False)
        jes = {k: JEngine(jm, batch=B, block_size=T, kernel=k) for k in ("pallas", "xla")}
        jss = {k: e.reset(prewarm=False) for k, e in jes.items()}
        for i in range(n_blocks):
            blk = x[:, i * T : (i + 1) * T]
            yt, fs = fe.process(blk, fs)
            for k, e in jes.items():
                yj, jss[k] = e.process(blk, jss[k])
                np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{k} {i}")


# Every activation type (None: Identity), one config each; and the modes.
ACT_CONFIGS = [None, "Tanh", "Hardtanh", "Fasttanh", "ReLU", "Sigmoid", "SiLU", "Hardswish", "Softsign",
               {"type": "LeakyReLU", "negative_slope": 0.2}, {"type": "PReLU", "negative_slope": 0.3},
               {"type": "LeakyHardtanh", "min_val": -0.5, "max_val": 0.7, "min_slope": 0.1, "max_slope": 0.05}]
MODE_SETS = {
    "none": (False, ()),
    "fast_tanh": (True, ()),
    "tanh_lut": (False, (("Tanh", -2.0, 2.0, 9),)),
    "sigmoid_lut": (False, (("Sigmoid", -4.0, 4.0, 100),)),
    "silu_lut": (False, (("SiLU", -3.0, 1.0, 7),)),
    "fast_tanh_and_all_luts": (True, (("Tanh", -2.0, 2.0, 9), ("Sigmoid", -4.0, 4.0, 100),
                                      ("SiLU", -3.0, 1.0, 7))),
}


@pytest.mark.parametrize("mode", sorted(MODE_SETS))
def test_kernel_code_follows_jax_apply_precedence(mode):
    """``kernel_code`` + ``kernel_apply`` (what the kernels and their plain
    versions run) against the JAX package's ``apply`` under the same modes,
    on inputs beyond every LUT's range; and the codes themselves: fast-tanh
    rebinds Tanh only, and before a Tanh LUT; a LUT rebinds its own
    function."""
    import jax.numpy as jnp

    fast, luts = MODE_SETS[mode]
    x = np.linspace(-6.0, 6.0, 2001).astype(np.float32)
    names = {lut[0] for lut in luts}
    with modes(fast, luts):
        for j in ACT_CONFIGS:
            cfg_t = tact.ActivationConfig() if j is None else tact.ActivationConfig.from_json(j)
            cfg_j = jact.ActivationConfig() if j is None else jact.ActivationConfig.from_json(j)
            code, prm = tact.kernel_code(cfg_t)
            assert prm.dtype == np.float32 and prm.shape == (tact.KERNEL_PARAMS,)
            if cfg_t.type == "Tanh" and fast:
                assert code == tact.KERNEL_CODES["Fasttanh"]
            elif cfg_t.type in names:
                assert code == tact.LUT_CODES[cfg_t.type]
            else:
                assert code == tact.KERNEL_CODES[cfg_t.type]
            y = tact.kernel_apply(code, torch.from_numpy(prm), torch.from_numpy(x)).numpy()
            yj = np.asarray(jact.apply(cfg_j, jnp.asarray(x)))
            np.testing.assert_allclose(y, yj, rtol=0, atol=2e-6, err_msg=f"{mode} {cfg_t.type}")
            # the torch engine tier's apply agrees too
            np.testing.assert_allclose(tact.apply(cfg_t, torch.from_numpy(x)).numpy(), y, rtol=0, atol=2e-6)


def _nam_file(tmp_path, preset="standard"):
    path = tmp_path / f"{preset}.nam"
    path.write_text(json.dumps(make_nam("WaveNet", wavenet_preset(preset), seed=1)))
    return path


def test_cli_loadmodel(tmp_path, capsys):
    from neuralampmodelercore_tpu_torch.cli import loadmodel

    path = _nam_file(tmp_path)
    assert loadmodel.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n_params = tnam.load_model(str(path), device="cpu").num_params()
    assert out.strip() == f"Loaded {path}: Model (WaveNet), 1 in / 1 out, {n_params} params, 48000 Hz"


@pytest.mark.parametrize("preset,args", [("standard", ["--engine", "--fast-tanh", "--batch", "4"]),
                                         ("simple", ["--batch", "2"])], ids=["engine_fast_tanh", "model"])
def test_cli_benchmodel(tmp_path, capsys, preset, args):
    """The JAX benchmodel's arguments and output line, --device cpu: the
    flagship through the engine (its fused tier) under fast-tanh, and a small
    model through Model.process; the fast-tanh mode stays on after the run,
    as the reference's does."""
    from neuralampmodelercore_tpu_torch.cli import benchmodel

    path = _nam_file(tmp_path, preset)
    try:
        assert benchmodel.main([str(path), "--device", "cpu", "--seconds", "0.05", *args]) == 0
        assert tact.using_fast_tanh == ("--fast-tanh" in args)
    finally:
        tact.disable_fast_tanh()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    batch = args[args.index("--batch") + 1]
    assert re.fullmatch(rf"[0-9.]+ ms to process 0\.05 s x {batch} streams \(buffer 64\); real-time bar 50 ms; "
                        r"(REAL-TIME|not real-time)", out), out
