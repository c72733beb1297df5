"""The wavefront-scheduled path of the port's stack kernel (K1g) against the
JAX package's (``wf_array``, stack.py:1053, behind ``WAVEFRONT``).

The reference corpus's wavenet_a1_standard, wavenet_a2_max and
wavenet_condition_dsp are not in the repository; their stand-ins are
``make_nam`` models of the same shapes (tools/agreement.py configs():
flagship, flagship_max, flagship_cond). Both packages' ``WAVEFRONT`` flags
are set in ``try``/``finally``. On the CPU the port's fused tier runs
``step_plain_wf``, the plain version that walks the kernel's micro-step
schedule on the kernel's state: it is held against the unpacked plain
version (outputs 1e-5, state 5e-5 after 6 blocks, as
tests/test_pallas_stack.py:490-532 holds the JAX paths) and against the JAX
Pallas kernel with ``WAVEFRONT`` on, in interpret mode at B=128, within
2e-5. The CUDA kernel itself is held against ``step_plain_wf`` on the card by
tests/test_torch_cuda.py."""

import contextlib

import numpy as np
import pytest
import torch

import neuralampmodelercore_tpu as jnam
import neuralampmodelercore_tpu_torch as tnam
from neuralampmodelercore_tpu.models.engine import StreamEngine as JEngine
from neuralampmodelercore_tpu.ops.pallas import stack as jstack
from neuralampmodelercore_tpu.tools.generate import make_nam
from neuralampmodelercore_tpu_torch.ops.cuda import stack as tstack
from neuralampmodelercore_tpu_torch.tools import agreement

B = 128
ATOL = 2e-5
CONFIGS = agreement.configs()
STAND_INS = {"wavenet_a1_standard": "flagship", "wavenet_a2_max": "flagship_max",
             "wavenet_condition_dsp": "flagship_cond"}


@contextlib.contextmanager
def wavefront(on: bool = True):
    old = jstack.WAVEFRONT, tstack.WAVEFRONT
    try:
        jstack.WAVEFRONT = tstack.WAVEFRONT = on
        yield
    finally:
        jstack.WAVEFRONT, tstack.WAVEFRONT = old


@pytest.fixture(autouse=True)
def _interpret_mode():
    jstack.INTERPRET = True
    yield
    jstack.INTERPRET = False


def _config(name):
    return CONFIGS[STAND_INS.get(name, name)][1:]


def _models(name, seed=None):
    config, s = _config(name)
    doc = make_nam("WaveNet", config, seed=s if seed is None else seed)
    return jnam.load_model(doc), tnam.load_model(doc, device="cpu")


def _layer_config(**kw):
    return {"layers": [agreement.small_layer(**kw)], "head": None}


# (model, T) -> the verdict: the three stand-ins, the sweep's small configs
# and one config per clause of the gate.
REASON_CASES = [
    ("wavenet_a1_standard", 64), ("wavenet_a1_standard", 16), ("wavenet_a1_standard", 20),
    ("wavenet_a1_standard", 18), ("wavenet_a2_max", 64), ("wavenet_condition_dsp", 64), ("depthwise", 64),
    ("post_head", 16), ("gated_bottleneck", 16), ("blended_head1x1", 16), ("film_conv_post_film", 16),
    ("head1x1_post_film", 16), ("condition_chain_depth2", 16), ("head_k16", 64),
]
EXTRA = {
    "gated_square": _layer_config(gated=True),
    "layer1x1_off": _layer_config(layer1x1={"active": False, "groups": 1}),
    "no_shallow_run": _layer_config(dilations=[1, 40, 2]),
    "two_inputs": {"in_channels": 2, "layers": [agreement.small_layer(input_size=2, condition_size=2)],
                   "head": None},
}


@pytest.mark.parametrize("name,T", REASON_CASES + [(k, 16) for k in EXTRA])
def test_wavefront_reason_matches_jax(name, T):
    """Same verdict as the JAX gate, flag on and flag off."""
    if name in EXTRA:
        doc = make_nam("WaveNet", EXTRA[name], seed=0)
        jcfg, tcfg = jnam.load_model(doc).config, tnam.load_model(doc, device="cpu").config
    else:
        jm, tm = _models(name)
        jcfg, tcfg = jm.config, tm.config
    with wavefront(True):
        assert tstack._wavefront_reason(tcfg, T) == jstack._wavefront_reason(jcfg, T)
    with wavefront(False):
        assert tstack._wavefront_reason(tcfg, T) == jstack._wavefront_reason(jcfg, T) == "disabled"
    expect_eligible = (name, T) in {("wavenet_a1_standard", 64), ("wavenet_a1_standard", 16),
                                    ("wavenet_a1_standard", 20), ("depthwise", 64), ("post_head", 16),
                                    ("head_k16", 64)}
    assert (tstack._wavefront_ineligible(tcfg, T) is None) == expect_eligible


def _jax_schedule(jcfg, T):
    """The JAX plan's segments as ("whole", li) and ("wf", active pairs)."""
    plan, _ = jstack._build_plan_cached(jcfg, T, B)
    out = []
    for ap in plan.nets[-1].arrays:
        steps = []
        for seg in ap.wf.segments:
            if seg.kind == "layer":
                steps.append(("whole", seg.li))
            else:
                steps += [("wf", tuple(mi.active)) for mi in seg.micros]
        out.append(steps)
    return out


def _port_schedule(micros):
    out = []
    for m in micros:
        if len(set(m)) == 1 and m[0] >= 0:
            out.append(("whole", m[0]))
        else:
            out.append(("wf", tuple(sorted((li, tau) for tau, li in enumerate(m) if li >= 0))))
    return out


@pytest.mark.parametrize("name,T", [("wavenet_a1_standard", 64), ("wavenet_a1_standard", 16),
                                    ("wavenet_a1_standard", 20), ("depthwise", 64), ("post_head", 16),
                                    ("head_k16", 64)])
def test_schedule_matches_jax_micros(name, T):
    """Per array, micro-step by micro-step, the active (layer, sub-tile)
    pairs are the JAX plan's; whole-block layers in the same places."""
    jm, tm = _models(name)
    with wavefront(True):
        jax_steps = _jax_schedule(jm.config, T)
        ep, _ = tstack.prepare(tm.config, tm.params, T, B)
    port = [_port_schedule(m) for m in ep["layout"].wf.micros]
    assert port == jax_steps
    if name == "wavenet_a1_standard" and T == 64:
        # dilations 1..32 are shallow (rf <= 64): 6 layers in 6 + 3 micro-steps, then 4 deep layers
        assert [len(m) for m in ep["layout"].wf.micros] == [13, 13]


def _blocks(T, n_blocks, seed=3):
    return (np.random.default_rng(seed).standard_normal((B, n_blocks * T)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name,T", [("wavenet_a1_standard", 16), ("wavenet_a1_standard", 20), ("post_head", 16),
                                    ("head_k16", 64)])
def test_plain_wavefront_matches_unpacked(name, T, monkeypatch):
    """step_plain_wf against step_plain, 6 blocks with state carried:
    outputs within 1e-5, the whole state within 5e-5 (the same state
    layout). T=20 gives sub-tiles of 5 frames; head_k16 carries its head
    rechannel's history."""
    _, tm = _models(name)
    walked = []
    monkeypatch.setattr(tstack, "step_plain_wf",
                        lambda *a, _f=tstack.step_plain_wf: walked.append(1) or _f(*a))
    x = _blocks(T, 6)
    outs, states = {}, {}
    for flag in (True, False):
        with wavefront(flag):
            eng = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
            assert eng.params["layout"].wf is not None and ("wf_sched" in eng.params)
            s = eng.reset(prewarm=False)
            ys = []
            for i in range(6):
                y, s = eng.process(x[:, i * T : (i + 1) * T], s)
                ys.append(y)
            outs[flag], states[flag] = torch.cat(ys, dim=1), s
    assert len(walked) == 6
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=1e-5)
    torch.testing.assert_close(states[True]["buf"], states[False]["buf"], rtol=0, atol=5e-5)
    assert states[True]["n"] == states[False]["n"]


def test_switching_wavefront_between_blocks_continues_the_stream():
    """The flag is read at every step: a stream that alternates between the
    two paths gives the unpacked path's output."""
    _, tm = _models("wavenet_a1_standard")
    T = 16
    x = _blocks(T, 6, seed=4)
    ref = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    eng = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
    rs, s = ref.reset(prewarm=False), eng.reset(prewarm=False)
    for i in range(6):
        blk = x[:, i * T : (i + 1) * T]
        yr, rs = ref.process(blk, rs)
        with wavefront(i % 2 == 0):
            y, s = eng.process(blk, s)
        torch.testing.assert_close(y, yr, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,T,n_blocks", [("wavenet_a1_standard", 16, 2), ("post_head", 16, 4),
                                             ("depthwise", 64, 2)])
def test_wavefront_matches_jax_pallas_wavefront(name, T, n_blocks):
    """The port's wavefront path against the JAX Pallas kernel with
    WAVEFRONT on (interpret mode) and the JAX XLA tier."""
    jm, tm = _models(name)
    x = _blocks(T, n_blocks, seed=5)
    with wavefront(True):
        fe = tnam.StreamEngine(tm, batch=B, block_size=T, kernel="fused")
        jes = {k: JEngine(jm, batch=B, block_size=T, kernel=k) for k in ("pallas", "xla")}
        plan, _ = jstack._build_plan_cached(jm.config, T, B)
        assert all(ap.wf is not None for ap in plan.nets[-1].arrays)
        fs = fe.reset(prewarm=False)
        jss = {k: e.reset(prewarm=False) for k, e in jes.items()}
        for i in range(n_blocks):
            blk = x[:, i * T : (i + 1) * T]
            yt, fs = fe.process(blk, fs)
            for k, e in jes.items():
                yj, jss[k] = e.process(blk, jss[k])
                np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL, err_msg=f"{k} {i}")


def test_supports_reckons_the_wavefront_shared_memory():
    """At T=512 with 32 channels even one stream's five layer-input slots do
    not fit in 227 KB: with WAVEFRONT on, supports gives the reason; off, the
    unpacked kernel runs it. The flagship fits at T=64 with the unpacked
    kernel's 8 streams per CTA."""
    doc = make_nam("WaveNet", _layer_config(channels=32, dilations=[1, 2]), seed=0)
    tm = tnam.load_model(doc, device="cpu")
    with wavefront(True):
        assert tstack._wavefront_ineligible(tm.config, 512) is None
        assert "wavefront path: shared memory" in tstack.supports(tm.config, 512, 4)
        _, flag = _models("wavenet_a1_standard")
        ep, _ = tstack.prepare(flag.config, flag.params, 64, 2048)
        wf = ep["layout"].wf
        assert (wf.BS, ep["layout"].BS) == (8, 8) and wf.smem_bytes <= tstack.SMEM_LIMIT
    with wavefront(False):
        assert tstack.supports(tm.config, 512, 4) is None
