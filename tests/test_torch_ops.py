"""Port ops against the JAX ops, one by one, on numpy-seeded inputs.

Tolerance 1e-6 absolute: both sides compute in float32 on the CPU, and the
only differences are the order of a few additions and the libm of each
framework."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralampmodelercore_tpu.formats import WeightReader as JReader
from neuralampmodelercore_tpu.ops import activations as jact
from neuralampmodelercore_tpu.ops import layers as jl
from neuralampmodelercore_tpu.ops import ring as jring
from neuralampmodelercore_tpu_torch.formats import WeightReader as TReader
from neuralampmodelercore_tpu_torch.ops import activations as tact
from neuralampmodelercore_tpu_torch.ops import layers as tl
from neuralampmodelercore_tpu_torch.ops import ring as tring

ATOL = 1e-6


def rng(seed=0):
    return np.random.default_rng(seed)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


ACTIVATIONS = [
    "Tanh", "Hardtanh", "Fasttanh", "ReLU", "Sigmoid", "SiLU", "Hardswish", "Softsign",
    {"type": "LeakyReLU", "negative_slope": 0.07},
    {"type": "PReLU", "negative_slope": 0.2},
    {"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3]},
    {"type": "LeakyHardtanh", "min_val": -0.4, "max_val": 0.8, "min_slope": 0.05, "max_slope": 0.2},
    "LeakyHardTanh",
]


@pytest.mark.parametrize("spec", ACTIVATIONS, ids=lambda s: s if isinstance(s, str) else s["type"])
@pytest.mark.parametrize("channel_axis", [-1, 0])
def test_activation_matches_jax(spec, channel_axis):
    x = (rng(1).standard_normal((6, 5, 6)) * 3).astype(np.float32)
    tc = tact.ActivationConfig.from_json(spec)
    jc = jact.ActivationConfig.from_json(spec)
    assert tc.type == jc.type
    close(tact.apply(tc, torch.tensor(x), channel_axis), jact.apply(jc, jnp.asarray(x), channel_axis))


def test_fast_tanh_and_fast_sigmoid_match_jax():
    x = np.linspace(-8, 8, 2001).astype(np.float32)
    close(tact.fast_tanh(torch.tensor(x)), jact.fast_tanh(jnp.asarray(x)))
    close(tact.fast_sigmoid(torch.tensor(x)), jact.fast_sigmoid(jnp.asarray(x)))


def test_fast_tanh_mode_matches_jax():
    x = (rng(2).standard_normal((64,)) * 2).astype(np.float32)
    cfg_t, cfg_j = tact.ActivationConfig.simple("Tanh"), jact.ActivationConfig.simple("Tanh")
    tact.enable_fast_tanh()
    jact.enable_fast_tanh()
    try:
        close(tact.apply(cfg_t, torch.tensor(x)), jact.apply(cfg_j, jnp.asarray(x)))
        assert not np.allclose(tact.apply(cfg_t, torch.tensor(x)).numpy(), np.tanh(x), atol=1e-5)
    finally:
        tact.disable_fast_tanh()
        jact.disable_fast_tanh()


@pytest.mark.parametrize("name,lo,hi,n", [("Tanh", -3.0, 3.0, 33), ("Sigmoid", -6.0, 6.0, 64), ("SiLU", -4.0, 5.0, 17)])
def test_lut_mode_matches_jax(name, lo, hi, n):
    x = np.concatenate([np.linspace(-8, 8, 1001), [lo, hi, hi - 1e-4]]).astype(np.float32)
    cfg_t, cfg_j = tact.ActivationConfig.simple(name), jact.ActivationConfig.simple(name)
    tact.enable_lut(name, lo, hi, n)
    jact.enable_lut(name, lo, hi, n)
    try:
        assert tact.lut_active()
        close(tact.apply(cfg_t, torch.tensor(x)), jact.apply(cfg_j, jnp.asarray(x)))
    finally:
        tact.disable_lut(name)
        jact.disable_lut(name)
    assert not tact.lut_active()
    with pytest.raises(ValueError):
        tact.enable_lut("ReLU", -1, 1, 8)


def test_activation_parse_errors():
    for bad in ("Nope", {"type": "Nope"}, 3):
        with pytest.raises(ValueError):
            tact.ActivationConfig.from_json(bad)
    with pytest.raises(ValueError, match="PReLU"):
        cfg = tact.ActivationConfig.from_json({"type": "PReLU", "negative_slopes": [0.1, 0.2]})
        tact.apply(cfg, torch.zeros(3, 5))


def _readers(n, seed):
    w = rng(seed).standard_normal(n).astype(np.float32)
    return TReader(w.copy()), JReader(w.copy())


@pytest.mark.parametrize("cin,cout,bias,groups", [(3, 5, True, 1), (4, 6, False, 2), (6, 6, True, 6), (1, 8, False, 1)])
def test_conv1x1_matches_jax(cin, cout, bias, groups):
    ts, js = tl.Conv1x1Spec(cin, cout, bias, groups), jl.Conv1x1Spec(cin, cout, bias, groups)
    assert ts.num_weights == js.num_weights
    tr, jr = _readers(ts.num_weights, 3)
    tp, jp = tl.conv1x1_params(ts, tr, "cpu"), jl.conv1x1_params(js, jr)
    assert tr.remaining == jr.remaining == 0
    x = rng(4).standard_normal((2, 7, cin)).astype(np.float32)
    close(tl.conv1x1_apply(ts, tp, torch.tensor(x)), jl.conv1x1_apply(js, jp, jnp.asarray(x)))


@pytest.mark.parametrize(
    "cin,cout,K,d,bias,groups", [(3, 5, 3, 2, True, 1), (4, 4, 2, 5, True, 2), (4, 4, 3, 3, False, 4), (2, 3, 1, 1, True, 1)]
)
def test_conv1d_step_matches_jax_over_blocks(cin, cout, K, d, bias, groups):
    ts = tl.Conv1dSpec(cin, cout, K, d, bias, groups)
    js = jl.Conv1dSpec(cin, cout, K, d, bias, groups)
    assert ts.num_weights == js.num_weights and ts.receptive_field == js.receptive_field
    tr, jr = _readers(ts.num_weights, 5)
    tp, jp = tl.conv1d_params(ts, tr, "cpu"), jl.conv1d_params(js, jr)
    tst, jst = tl.conv1d_init_state(ts, 2, "cpu"), jl.conv1d_init_state(js, 2)
    x = rng(6).standard_normal((2, 40, cin)).astype(np.float32)
    for a, b in ((0, 7), (7, 8), (8, 30), (30, 40)):
        ty, tst = tl.conv1d_step(ts, tp, tst, torch.tensor(x[:, a:b]))
        jy, jst = jl.conv1d_step(js, jp, jst, jnp.asarray(x[:, a:b]))
        close(ty, jy)
        close(tst, jst)


@pytest.mark.parametrize("shift,groups", [(True, 1), (False, 1), (True, 2)])
def test_film_matches_jax(shift, groups):
    ts, js = tl.FiLMSpec(2, 4, shift, groups), jl.FiLMSpec(2, 4, shift, groups)
    tr, jr = _readers(ts.num_weights, 7)
    tp, jp = tl.film_params(ts, tr, "cpu"), jl.film_params(js, jr)
    x = rng(8).standard_normal((3, 5, 4)).astype(np.float32)
    c = rng(9).standard_normal((3, 5, 2)).astype(np.float32)
    close(tl.film_apply(ts, tp, torch.tensor(x), torch.tensor(c)), jl.film_apply(js, jp, jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("mode", ["gated", "blended"])
def test_gating_and_blending_match_jax(mode):
    z = (rng(10).standard_normal((2, 6, 8)) * 2).astype(np.float32)
    pa, sa = "Tanh", "Sigmoid"
    tf, jf = (tl.gated_apply, jl.gated_apply) if mode == "gated" else (tl.blended_apply, jl.blended_apply)
    close(
        tf(tact.ActivationConfig.from_json(pa), tact.ActivationConfig.from_json(sa), torch.tensor(z), 4),
        jf(jact.ActivationConfig.from_json(pa), jact.ActivationConfig.from_json(sa), jnp.asarray(z), 4),
    )


@pytest.mark.parametrize("cin,cout,K,d,groups,T", [(3, 4, 3, 5, 1, 4), (4, 4, 3, 2, 4, 8), (2, 2, 2, 16, 1, 8)])
def test_ring_conv_step_matches_jax_over_blocks(cin, cout, K, d, groups, T):
    """Ring tier (chunk windows, splices, in-place writes) against the JAX ring."""
    ts = tl.Conv1dSpec(cin, cout, K, d, True, groups)
    js = jl.Conv1dSpec(cin, cout, K, d, True, groups)
    tr, jr = _readers(ts.num_weights, 11)
    tp, jp = tl.conv1d_params(ts, tr, "cpu"), jl.conv1d_params(js, jr)
    tep, jep = tring.conv1d_w_ctb(ts, tp), jring.conv1d_w_ctb(js, jp)
    B = 3
    tst, jst = tring.ring_conv_init(ts, T, B, "cpu"), jring.ring_conv_init(js, T, B)
    assert tst["chunks"].shape == tuple(jst["chunks"].shape)
    x = rng(12).standard_normal((9, cin, T, B)).astype(np.float32)
    for i in range(9):
        ty, tst = tring.ring_conv_step(ts, T, tep, tst, torch.tensor(x[i]))
        jy, jst = jring.ring_conv_step(js, T, jep, jst, jnp.asarray(x[i]))
        close(ty, jy)
        assert tst["n"] == int(jst["n"])
    close(tst["chunks"], jst["chunks"])
    with pytest.raises(ValueError, match="block size"):
        tring.ring_conv_step(ts, T, tep, tst, torch.zeros(cin, T + 1, B))


def test_weight_reader_errors():
    r = TReader(np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="negative"):
        r.take(-1)
    r.take(2)
    with pytest.raises(ValueError, match="Weight mismatch"):
        r.assert_exhausted()
    with pytest.raises(ValueError, match="Weight mismatch"):
        r.take(2)
    with pytest.raises(ValueError, match="divisible"):
        tl.conv1x1_params(tl.Conv1x1Spec(3, 4, True, 2), TReader(np.zeros(20, np.float32)), "cpu")
