"""WaveNet tiers of the port against the JAX package.

The same document and the same numpy input go to both. The JAX generic step
processes the whole signal in one call; the port's generic tier processes it
in blocks of mixed sizes (block-size invariance) and its torch engine tier
in fixed blocks with ring state carried. Tolerance 2e-5 absolute: the JAX
package's own tier-against-tier tolerance (tests/test_pallas_stack.py:32),
below the reference's 5e-5 gate."""

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.wavenet import FILM_SITES
from neuralampmodelercore_tpu.tools.generate import make_nam, wavenet_preset, with_condition_dsp

ATOL = 2e-5
B = 2


def _layer(**kw):
    base = dict(input_size=1, condition_size=1, head_size=1, channels=4, kernel_size=3,
                dilations=[1, 3, 8], activation="Tanh", gated=False, head_bias=True)
    base.update(kw)
    return base


def _film_config(site):
    kw = {site: {"active": True, "shift": site != "activation_post_film"}}
    if site == "head1x1_post_film":
        kw["head1x1"] = {"active": True, "out_channels": 3, "groups": 1}
    if site == "layer1x1_post_film":
        # The film only acts in blended mode (reference quirk, model.cpp:262-270).
        kw.update(gating_mode="blended", secondary_activation="Sigmoid")
    return {"layers": [_layer(**kw)], "head": None}


CONFIGS = {
    "simple": wavenet_preset("simple"),
    "standard": wavenet_preset("standard"),
    "gated": {"layers": [_layer(channels=6, bottleneck=3, gated=True, activation="ReLU"),
                         _layer(input_size=6, channels=1, head_size=1, gated=True)], "head": None},
    "blended": {"layers": [_layer(gating_mode=["blended", "none", "gated"],
                                  secondary_activation=["Hardtanh", "Tanh", "Sigmoid"])], "head": None},
    "layer1x1_post_film_none_gating": {
        "layers": [_layer(layer1x1_post_film={"active": True, "shift": True})], "head": None},
    "post_head": {"layers": [_layer(head_size=3)],
                  "head": {"channels": 4, "out_channels": 2, "kernel_sizes": [3, 2], "activation": "Softsign"}},
    "groups_depthwise": {"layers": [_layer(channels=4, groups_input=4, groups_input_mixin=1,
                                           layer1x1={"active": True, "groups": 2})], "head": None},
    "condition_dsp": with_condition_dsp({"layers": [_layer()], "head": None},
                                        make_nam("WaveNet", wavenet_preset("simple"), seed=21)),
}
CONFIGS.update({f"film_{s}": _film_config(s) for s in FILM_SITES})


def _models(config, seed=7):
    doc = make_nam("WaveNet", config, seed=seed)
    jm = jnam.load_model(doc)
    tm = tnam.load_model(doc, device="cpu")
    jm.prewarm_on_reset = tm.prewarm_on_reset = False
    return jm, tm


def _input(n, cin, seed=3):
    return (np.random.default_rng(seed).standard_normal((B, n, cin)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generic_tier_mixed_blocks_matches_jax(name):
    jm, tm = _models(CONFIGS[name])
    x = _input(160, jm.num_input_channels)
    yj, _ = jm.process(x, jm.reset(batch=B))
    st = tm.reset(batch=B)
    ys = []
    for a, b in ((0, 37), (37, 101), (101, 106), (106, 160)):
        y, st = tm.process(x[:, a:b], st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), np.asarray(yj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_tier_matches_jax(name):
    """Ring-state engine tier at T=16, where deep dilations wrap the rings."""
    jm, tm = _models(CONFIGS[name])
    T, nb = 16, 10
    x = _input(T * nb, jm.num_input_channels, seed=4)
    yj, _ = jm.process(x, jm.reset(batch=B))
    eng = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="torch")
    assert eng.kernel == "torch"
    st = eng.reset(prewarm=False)
    ys = []
    for i in range(nb):
        y, st = eng.process(torch.tensor(x[:, i * T : (i + 1) * T]), st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), np.asarray(yj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["simple", "standard", "condition_dsp", "post_head"])
def test_prewarm_and_render_match_jax(name):
    """Exact-count prewarm (full blocks + remainder) and the offline render."""
    doc = make_nam("WaveNet", CONFIGS[name], seed=9)
    jm, tm = jnam.load_model(doc), tnam.load_model(doc, device="cpu")
    assert tm.prewarm_on_reset
    x = _input(48, jm.num_input_channels, seed=5)
    js = jm.reset(batch=B, max_buffer_size=100)
    ts = tm.reset(batch=B, max_buffer_size=100)
    yj, _ = jm.process(x, js)
    yt, _ = tm.process(x, ts)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.render(x).numpy(), np.asarray(jm.render(x)), rtol=0, atol=ATOL)


def test_mono_and_rank_conventions():
    jm, tm = _models(CONFIGS["simple"])
    x = _input(20, 1)[..., 0]  # (B, T) mono
    y, _ = tm.process(x, tm.reset(batch=B))
    assert y.shape == (B, 20)
    assert tm.render(x[0]).shape == (20,)
    assert tm.render(x).shape == (B, 20)
    assert tm.num_output_channels == jm.num_output_channels == 1
