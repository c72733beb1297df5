"""Agreement sweep of the port: each fused kernel against the port's torch
engine tier, on the same input and from the same state.

The port's analog of ``tools/ondevice_agreement.py``: interpret-mode and plain
versions run one thread of work at a time and cannot show what the card's
parallel run gets wrong, so this runs the real kernels (``StreamEngine
(kernel="fused")``) against ``kernel="torch"`` for ``--blocks`` blocks at each
batch of ``--batches`` and T = 64, and holds every output to ``ATOL`` (2e-5,
the JAX package's tier-against-tier tolerance). It writes
one JSON per config into ``--out``. Its configs: those of
``AGREEMENT_r05.json`` that the repository builds without the reference's
example models (post_head, depthwise, lstm_2x8, convnet, and the flagship,
whose shape is ``wavenet_a1_standard``'s), the LSTMs of ``chip_smoke.py``'s
main paths (2 x 16 and 48 x 2), every WaveNet feature of the
stack kernel, the two feature main paths of ``chip_smoke.py`` included, the
reference's LARGE preset and a gated MEDIUM (both on the wide kernel,
``csrc/stack_wide.cu``), and the flagship and the ConvNet under the
fast-tanh and LUT modes and on the wavefront path (``MODES``: each is swept
with its mode set around it).

    python3 -m neuralampmodelercore_tpu_torch.tools.agreement [--out DIR]

It runs on the card unless ``--device cpu`` is given; on the CPU the fused
tier is each kernel's plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

DILATIONS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512]
T = 64  # block size of every sweep
ATOL = 2e-5  # tier-against-tier tolerance of the JAX package (tests/test_pallas_stack.py:32)


# Configs swept under a global mode or the wavefront flag:
# name -> (fast-tanh, LUTs as (name, min_x, max_x, n_points), WAVEFRONT).
MODES = {
    "flagship_fast_tanh": (True, (), False),
    "flagship_lut": (False, (("Tanh", -5.0, 5.0, 512),), False),
    "convnet_fast_tanh": (True, (), False),
    "flagship_wavefront": (False, (), True),
}


@contextlib.contextmanager
def modes(fast_tanh: bool = False, luts=(), wavefront: bool = False):
    """Switch the fast-tanh mode, LUTs ((name, min_x, max_x, n_points) each)
    and the stack kernel's WAVEFRONT flag on, and off again on exit."""
    from ..ops import activations as act
    from ..ops.cuda import stack

    try:
        if fast_tanh:
            act.enable_fast_tanh()
        for lut in luts:
            act.enable_lut(*lut)
        stack.WAVEFRONT = wavefront
        yield
    finally:
        act.disable_fast_tanh()
        for lut in luts:
            act.disable_lut(lut[0])
        stack.WAVEFRONT = False


def mode(name: str):
    """``modes`` of config ``name`` (none for a config not in MODES)."""
    return modes(*MODES.get(name, (False, (), False)))


def film(shift: bool = True) -> dict:
    return {"active": True, "shift": shift, "groups": 1}


def small_layer(**kw) -> dict:
    """A 4-channel layer array whose last dilation wraps its ring at T=16."""
    base = dict(input_size=1, condition_size=1, head_size=2, channels=4, kernel_size=3, dilations=[1, 8, 32],
                activation="Tanh", gated=False, head_bias=True)
    base.update(kw)
    return base


def flagship_max() -> dict:
    """Everything on at the flagship's widths (16 then 8 channels, k=3,
    dilations 1..512): gating, blending, bottleneck, head1x1, FiLM at all 8
    sites, the A2 family's k=16 head conv with bias, and a post-stack head;
    the analog of the reference corpus's wavenet_a2_max."""
    return {
        "layers": [
            dict(input_size=1, condition_size=1, channels=16, bottleneck=8, kernel_size=3, dilations=DILATIONS,
                 activation="Tanh", gating_mode="gated", secondary_activation="Sigmoid",
                 head1x1={"active": True, "out_channels": 8, "groups": 1},
                 head={"out_channels": 8, "kernel_size": 1, "bias": False},
                 conv_pre_film=film(), input_mixin_post_film=film(), activation_post_film=film(False),
                 head1x1_post_film=film()),
            dict(input_size=16, condition_size=1, channels=8, kernel_size=3, dilations=DILATIONS,
                 activation={"type": "LeakyReLU", "negative_slope": 0.01}, gating_mode="blended",
                 secondary_activation="Sigmoid",
                 head={"out_channels": 4, "kernel_size": 16, "bias": True},
                 conv_post_film=film(), input_mixin_pre_film=film(), activation_pre_film=film(False),
                 layer1x1_post_film=film()),
        ],
        "head": {"channels": 5, "out_channels": 1, "kernel_sizes": [3, 1, 4], "activation": "ReLU"},
        "head_scale": 0.02,
    }


def medium_gated() -> dict:
    """The reference's MEDIUM preset (32 then 16 channels, dilations 1..512)
    with every layer gated: 2 * 32 conv rows in the first array."""
    from .generate import wavenet_preset

    config = wavenet_preset("medium")
    for ac in config["layers"]:
        ac["gated"] = True
    return config


def _chain_layers(ch: int, ks: int, dil, head: int) -> dict:
    return {"layers": [small_layer(channels=ch, kernel_size=ks, dilations=dil, head_size=head)], "head": None}


def configs() -> Dict[str, Tuple[str, dict, int]]:
    """name -> (architecture, config, seed of the weights)."""
    from .generate import make_nam, wavenet_preset, with_condition_dsp

    deepest = make_nam("WaveNet", _chain_layers(3, 2, [1, 4], 2), seed=21)
    middle = make_nam("WaveNet", with_condition_dsp(_chain_layers(4, 3, [1, 8], 3), deepest), seed=22)
    out: Dict[str, Tuple[str, dict, int]] = {
        # From AGREEMENT_r05.json (tools/ondevice_agreement.py:29-84).
        "flagship": ("WaveNet", wavenet_preset("standard"), 1),
        "post_head": ("WaveNet", {
            "layers": [small_layer(channels=6, head_size=4, dilations=[1, 4, 16, 64])],
            "head": {"channels": 5, "out_channels": 1, "kernel_sizes": [3, 1, 4], "activation": "ReLU"},
        }, 11),
        "depthwise": ("WaveNet", {
            "layers": [small_layer(channels=8, dilations=[1, 2, 4, 128], activation="SiLU", head_bias=False,
                                   groups_input=8, layer1x1={"active": True, "groups": 8})],
            "head": None,
        }, 12),
        "lstm_2x8": ("LSTM", {"num_layers": 2, "input_size": 1, "hidden_size": 8, "out_channels": 1}, 13),
        # chip_smoke.py's two LSTM main paths (tools/generate.py's LSTM and
        # 48 x 2), both on csrc/lstm_wide.cu's tile kernel at B = 2,048.
        "lstm_2x16": ("LSTM", {"num_layers": 2, "input_size": 1, "hidden_size": 16, "out_channels": 1}, 14),
        "lstm_48x2": ("LSTM", {"num_layers": 2, "input_size": 1, "hidden_size": 48, "out_channels": 1}, 15),
        "convnet": ("ConvNet", {"channels": 16, "dilations": DILATIONS, "batchnorm": True, "activation": "Tanh"}, 7),
        # The stack kernel's features (K1b-K1e).
        "gated_bottleneck": ("WaveNet", {"layers": [
            small_layer(channels=8, bottleneck=4, head_size=4, kernel_size=2, dilations=[1, 4, 16], gated=True,
                        head_bias=False),
            small_layer(input_size=8, channels=4, head_size=1, dilations=[2, 8], activation="ReLU"),
        ], "head": None}, 2),
        "blended_head1x1": ("WaveNet", {"layers": [
            small_layer(channels=6, head_size=1, dilations=[1, 5], activation="Sigmoid", gating_mode="blended",
                        secondary_activation="Hardtanh", head1x1={"active": True, "out_channels": 6, "groups": 1}),
        ], "head": None}, 3),
        "layer1x1_post_film_blended": ("WaveNet", {"layers": [
            small_layer(gating_mode="blended", layer1x1_post_film=film())], "head": None}, 4),
        "layer1x1_post_film_none": ("WaveNet", {"layers": [small_layer(layer1x1_post_film=film())], "head": None}, 5),
        "head1x1_post_film": ("WaveNet", {"layers": [
            small_layer(head1x1={"active": True, "out_channels": 3, "groups": 1}, head1x1_post_film=film(False))],
            "head": None}, 6),
        "head_k16": ("WaveNet", {"layers": [small_layer(head={"out_channels": 2, "kernel_size": 16, "bias": True})]}, 8),
        "prelu_per_channel": ("WaveNet", {"layers": [
            small_layer(channels=4, bottleneck=4, gated=True,
                        activation={"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3, 0.4]},
                        secondary_activation={"type": "PReLU", "negative_slopes": [0.5, 0.05]})],
            "head": None}, 9),
        "condition_chain_depth2": ("WaveNet", with_condition_dsp(_chain_layers(6, 3, [1, 4, 16], 1), middle), 23),
        "condition_lstm_prepass": ("WaveNet", with_condition_dsp(
            _chain_layers(6, 3, [1, 4, 16], 1),
            make_nam("LSTM", {"input_size": 1, "hidden_size": 3, "num_layers": 1}, seed=3)), 10),
        "flagship_cond": ("WaveNet", with_condition_dsp(
            wavenet_preset("standard"), make_nam("WaveNet", wavenet_preset("small"), seed=21)), 1234),
        "flagship_max": ("WaveNet", flagship_max(), 1234),
        # Wider than the register tile of csrc/stack.cu: the wide kernel.
        "large": ("WaveNet", wavenet_preset("large"), 1234),
        "medium_gated": ("WaveNet", medium_gated(), 1234),
    }
    for name in MODES:  # the flagship or the ConvNet under a mode
        out[name] = out["convnet" if name.startswith("convnet") else "flagship"]
    for i, (site, shift) in enumerate((
        ("conv_pre_film", True), ("conv_post_film", False), ("input_mixin_pre_film", True),
        ("input_mixin_post_film", True), ("activation_pre_film", False), ("activation_post_film", True),
    )):
        out[f"film_{site}"] = ("WaveNet", {"layers": [small_layer(**{site: film(shift)})], "head": None}, 30 + i)
    return out


def sweep(names: Optional[Iterable[str]] = None, batches=(256, 512), blocks: int = 8,
          device: str = "cuda", out: Optional[str] = None,
          log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Fused tier against torch tier per config and batch; returns (and, with
    ``out``, writes) {name: {"B<b>": {"max_abs_diff", "ok"}, "ok"}}."""
    import neuralampmodelercore_tpu_torch as nam
    from .generate import make_nam

    table = configs()
    results = {}
    for name in names or table:
        arch, config, seed = table[name]
        with mode(name):
            res = _sweep_one(nam, make_nam(arch, config, seed=seed), name, seed, batches, blocks, device, log)
        results[name] = res
        if out:
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, f"{name}.json"), "w") as f:
                json.dump({"config": name, "architecture": arch, "seed": seed, "block_size": T, "blocks": blocks,
                           "atol": ATOL, "device": device, "mode": MODES.get(name), **res}, f, indent=1)
    return results


def _sweep_one(nam, doc, name, seed, batches, blocks, device, log) -> dict:
    import torch

    model = nam.load_model(doc, device=device)
    res = {}
    for B in batches:
        fe = nam.StreamEngine(model, batch=B, block_size=T, kernel="fused")
        te = nam.StreamEngine(model, batch=B, block_size=T, kernel="torch")
        fs, ts = fe.reset(prewarm=False), te.reset(prewarm=False)
        rng = np.random.default_rng(seed)
        worst = 0.0
        with torch.no_grad():
            for _ in range(blocks):
                x = torch.as_tensor(
                    (rng.standard_normal((model.num_input_channels, T, B)) * 0.3).astype(np.float32), device=device)
                yf, fs = fe.step(fs, x)
                yt, ts = te.step(ts, x)
                worst = max(worst, (yf - yt).abs().max().item())
                if not torch.isfinite(yf).all():
                    worst = float("inf")
        res[f"B{B}"] = {"max_abs_diff": worst, "ok": worst <= ATOL}
        log(f"{'OK  ' if worst <= ATOL else 'FAIL'} {name:28s} B={B} T={T}: max|fused - torch| {worst:.3e}")
        del fe, te, fs, ts
    res["ok"] = all(r["ok"] for k, r in res.items() if k.startswith("B"))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--batches", default="256,512")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/agreement", help="directory for one JSON per config")
    ap.add_argument("configs", nargs="*", help="config names (default: all)")
    args = ap.parse_args(argv)
    res = sweep(args.configs or None, tuple(int(b) for b in args.batches.split(",")), args.blocks, args.device,
                args.out)
    bad = [k for k, r in res.items() if not r["ok"]]
    print(f"agreement: {len(res) - len(bad)}/{len(res)} configs within {ATOL}" + (f"; failed: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
