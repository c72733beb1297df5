"""Generate .nam model files with random weights.

The analog of the reference's offline tooling (reference:
tools/create_wavenet.py — exact weight-count bookkeeping for arbitrary
WaveNet configs, :44-100 — and generate_weights_a2.py — full A2 feature set
incl. FiLMs, head1x1, nested condition DSP, gating modes).

The weight-count arithmetic here is written independently of the loader
(``models/*.py``) so tests can use it as a second bookkeeping oracle. This is
the port's own copy of ``neuralampmodelercore_tpu.tools.generate``: it is
numpy-only, and the same seed gives the same document in both packages.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def _film_count(cfg: Optional[dict], cond: int, dim: int) -> int:
    """FiLM = Conv1x1(cond -> (2 if shift else 1)*dim) with bias
    (reference: NAM/film.h:28-31)."""
    if not cfg or cfg is False:
        return 0
    if not cfg.get("active", True):
        return 0
    mult = 2 if cfg.get("shift", True) else 1
    groups = cfg.get("groups", 1)
    out = mult * dim
    return (out // groups) * (cond // groups) * groups + out


def _conv1x1_count(cin: int, cout: int, bias: bool, groups: int = 1) -> int:
    if groups == cin and cin == cout:  # depthwise
        n = cin
    else:
        n = (cout // groups) * (cin // groups) * groups
    return n + (cout if bias else 0)


def _conv1d_count(cin: int, cout: int, k: int, bias: bool, groups: int = 1) -> int:
    if groups == cin and cin == cout:
        n = cin * k
    else:
        n = (cout // groups) * (cin // groups) * k * groups
    return n + (cout if bias else 0)


def wavenet_weight_count(config: dict) -> int:
    """Exact weight count for a WaveNet config JSON (excluding any nested
    condition_dsp, whose weights live in its own .nam spec)."""
    total = 0
    for lc in config["layers"]:
        channels = lc["channels"]
        bottleneck = lc.get("bottleneck", channels)
        cond = lc["condition_size"]
        input_size = lc["input_size"]
        dil = lc["dilations"]
        n = len(dil)
        ks = lc["kernel_sizes"] if "kernel_sizes" in lc else [lc["kernel_size"]] * n
        # gating per layer
        if "gating_mode" in lc:
            gm = lc["gating_mode"]
            gates = [g != "none" for g in (gm if isinstance(gm, list) else [gm] * n)]
        else:
            gates = [bool(lc.get("gated", False))] * n
        layer1x1 = lc.get("layer1x1", {"active": True, "groups": 1})
        head1x1 = lc.get("head1x1", {"active": False, "out_channels": channels, "groups": 1})
        g_in = lc.get("groups_input", 1)
        g_mix = lc.get("groups_input_mixin", 1)

        total += _conv1x1_count(input_size, channels, False)  # rechannel
        for i in range(n):
            zc = 2 * bottleneck if gates[i] else bottleneck
            total += _conv1d_count(channels, zc, ks[i], True, g_in)  # conv
            total += _conv1x1_count(cond, zc, False, g_mix)  # mixin
            if layer1x1["active"]:
                total += _conv1x1_count(bottleneck, channels, True, layer1x1["groups"])
            if head1x1["active"]:
                total += _conv1x1_count(bottleneck, head1x1["out_channels"], True, head1x1["groups"])
            total += _film_count(lc.get("conv_pre_film"), cond, channels)
            total += _film_count(lc.get("conv_post_film"), cond, zc)
            total += _film_count(lc.get("input_mixin_pre_film"), cond, cond)
            total += _film_count(lc.get("input_mixin_post_film"), cond, zc)
            total += _film_count(lc.get("activation_pre_film"), cond, zc)
            total += _film_count(lc.get("activation_post_film"), cond, bottleneck)
            if layer1x1["active"]:
                total += _film_count(lc.get("layer1x1_post_film"), cond, channels)
            if head1x1["active"]:
                total += _film_count(lc.get("head1x1_post_film"), cond, head1x1["out_channels"])
        # head rechannel
        head_out = head1x1["out_channels"] if head1x1["active"] else bottleneck
        if lc.get("head") is not None:
            hj = lc["head"]
            total += _conv1d_count(head_out, hj["out_channels"], hj["kernel_size"], hj["bias"])
        else:
            total += _conv1d_count(head_out, lc["head_size"], 1, lc["head_bias"])
    # post-stack head
    if config.get("head") is not None:
        hj = config["head"]
        cin = (
            config["layers"][-1].get("head_size")
            or config["layers"][-1]["head"]["out_channels"]
        )
        nks = len(hj["kernel_sizes"])
        for i, k in enumerate(hj["kernel_sizes"]):
            cout = hj["out_channels"] if i + 1 == nks else hj["channels"]
            total += _conv1d_count(cin, cout, k, True)
            cin = cout
    return total + 1  # trailing head_scale


def lstm_weight_count(config: dict) -> int:
    H = config["hidden_size"]
    total = 0
    for li in range(config["num_layers"]):
        isz = config["input_size"] if li == 0 else H
        total += 4 * H * (isz + H) + 4 * H + 2 * H  # W, b, h0, c0
    out = config.get("out_channels", 1)
    return total + out * H + out  # head W + bias


def convnet_weight_count(config: dict) -> int:
    ch = config["channels"]
    cin = config.get("in_channels", 1)
    bn = config["batchnorm"]
    groups = config.get("groups", 1)
    total = 0
    for i, _ in enumerate(config["dilations"]):
        total += _conv1d_count(cin if i == 0 else ch, ch, 2, not bn, groups)
        if bn:
            total += 4 * ch + 1
    out = config.get("out_channels", 1)
    return total + out * ch + out


def make_nam(architecture: str, config: dict, *, version: str = "0.5.4",
             sample_rate: float = 48000, seed: int = 0, scale: float = 0.3,
             metadata: Optional[dict] = None) -> dict:
    """Build a .nam JSON dict with random weights of the exact expected count."""
    counts = {
        "WaveNet": wavenet_weight_count,
        "LSTM": lstm_weight_count,
        "ConvNet": convnet_weight_count,
        "Linear": lambda c: c["receptive_field"] + (1 if c["bias"] else 0),
    }
    n = counts[architecture](config)
    rng = np.random.default_rng(seed)
    weights = (rng.standard_normal(n) * scale).astype(np.float32)
    if architecture == "ConvNet" and config["batchnorm"]:
        # BatchNorm running_var and eps must be positive (they pass through
        # sqrt at load, reference: NAM/convnet.cpp:35).
        ch = config["channels"]
        cin = config.get("in_channels", 1)
        groups = config.get("groups", 1)
        pos = 0
        for i, _ in enumerate(config["dilations"]):
            pos += _conv1d_count(cin if i == 0 else ch, ch, 2, False, groups)
            pos += ch  # running_mean
            weights[pos : pos + ch] = np.abs(weights[pos : pos + ch]) + 0.5  # running_var
            pos += 3 * ch  # var, weight, bias
            weights[pos] = 1e-5  # eps
            pos += 1
    doc = {
        "version": version,
        "architecture": architecture,
        "config": config,
        "weights": [float(w) for w in weights],
        "sample_rate": sample_rate,
    }
    if metadata is not None:
        doc["metadata"] = metadata
    return doc


# -- presets (reference: create_wavenet.py simple/small/medium/large
#    presets, :303-414) ------------------------------------------------------


def wavenet_preset(name: str = "standard") -> dict:
    """Config presets mirroring the reference's generator presets."""
    presets = {
        "simple": [
            dict(input_size=1, condition_size=1, head_size=2, channels=3, kernel_size=3,
                 dilations=[1, 2], activation="Tanh", gated=False, head_bias=False),
            dict(input_size=3, condition_size=1, head_size=1, channels=2, kernel_size=3,
                 dilations=[8], activation="Tanh", gated=False, head_bias=True),
        ],
        "standard": [
            dict(input_size=1, condition_size=1, head_size=8, channels=16, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512], activation="Tanh",
                 gated=False, head_bias=False),
            dict(input_size=16, condition_size=1, head_size=1, channels=8, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512], activation="Tanh",
                 gated=False, head_bias=True),
        ],
        # (reference: create_wavenet.py:331-414 — SMALL/MEDIUM/LARGE examples)
        "small": [
            dict(input_size=1, condition_size=1, head_size=8, channels=16, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32], activation="Tanh",
                 gated=False, head_bias=False),
            dict(input_size=16, condition_size=1, head_size=1, channels=8, kernel_size=3,
                 dilations=[64, 128, 256], activation="Tanh", gated=False, head_bias=True),
        ],
        "medium": [
            dict(input_size=1, condition_size=1, head_size=16, channels=32, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512], activation="Tanh",
                 gated=False, head_bias=False),
            dict(input_size=32, condition_size=1, head_size=1, channels=16, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512], activation="Tanh",
                 gated=False, head_bias=True),
        ],
        "large": [
            dict(input_size=1, condition_size=1, head_size=32, channels=64, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024], activation="Tanh",
                 gated=False, head_bias=False),
            dict(input_size=64, condition_size=1, head_size=1, channels=32, kernel_size=3,
                 dilations=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024], activation="Tanh",
                 gated=False, head_bias=True),
        ],
    }
    return {"layers": presets[name], "head": None, "head_scale": 0.02}


def with_condition_dsp(config: dict, condition_doc: dict) -> dict:
    """Nest a full .nam document as the config's condition DSP and rewire
    every layer's condition_size to the nested model's output channel count
    (reference: the condition-DSP recursion, NAM/wavenet/model.cpp:841-852;
    channel-match validation model.cpp:591-600). condition_doc comes from
    make_nam — any architecture."""
    sub_cfg = condition_doc["config"]
    arch = condition_doc["architecture"]
    if arch == "WaveNet":
        last = sub_cfg["layers"][-1]
        out = (
            sub_cfg["head"]["out_channels"] if sub_cfg.get("head")
            else last.get("head_size") or last["head"]["out_channels"]
        )
    elif arch == "LSTM":
        out = sub_cfg.get("out_channels", 1)
    else:  # ConvNet / Linear heads are mono
        out = sub_cfg.get("out_channels", 1)
    cfg = dict(config, condition_dsp=condition_doc)
    cfg["layers"] = [dict(lc, condition_size=out) for lc in config["layers"]]
    return cfg


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="nam-generate", description=__doc__)
    ap.add_argument("output", help="output .nam path")
    ap.add_argument("--arch", default="WaveNet", choices=["WaveNet", "LSTM", "ConvNet", "Linear"])
    ap.add_argument("--preset", default="standard", help="WaveNet preset (simple|standard|small|medium|large)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--condition-dsp", default=None, choices=["WaveNet", "LSTM"],
                    help="nest a generated model of this architecture as the condition DSP")
    args = ap.parse_args(argv)
    if args.arch == "WaveNet":
        config = wavenet_preset(args.preset)
        if args.condition_dsp == "WaveNet":
            sub = make_nam("WaveNet", wavenet_preset("simple"), seed=args.seed + 1)
            config = with_condition_dsp(config, sub)
        elif args.condition_dsp == "LSTM":
            sub = make_nam("LSTM", {"input_size": 1, "hidden_size": 4, "num_layers": 1,
                                    "out_channels": 2}, seed=args.seed + 1)
            config = with_condition_dsp(config, sub)
    elif args.arch == "LSTM":
        config = {"input_size": 1, "hidden_size": 16, "num_layers": 2}
    elif args.arch == "ConvNet":
        config = {"channels": 8, "dilations": [1, 2, 4, 8], "batchnorm": True, "activation": "Tanh"}
    else:
        config = {"receptive_field": 64, "bias": True}
    doc = make_nam(args.arch, config, seed=args.seed)
    with open(args.output, "w") as f:
        json.dump(doc, f)
    print(f"wrote {args.output} ({len(doc['weights'])} weights)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
