"""ConvNet: blocks of (dilated Conv1D k=2 -> folded BatchNorm -> activation)
plus a linear head.

The port of ``neuralampmodelercore_tpu.models.convnet`` (reference:
NAM/convnet.{h,cpp}). The fused tier runs the whole block chain in one
hand-written CUDA kernel (ops/cuda/convnet.py).

Weight-stream contract (reference: NAM/convnet.cpp:50-61, 14-37, 133-153):
  per block: Conv1D weights (kernel 2, bias iff NOT batchnorm), then
  BatchNorm running_mean(d), running_var(d), weight(d), bias(d), eps (1);
  then head: W (out x channels) row-major + bias (out).
BatchNorm is folded at load into scale/loc: scale = w/sqrt(eps+var),
loc = b - scale*mean (reference: convnet.cpp:30-37), in float64 and then
cast to float32, as the JAX package does: a float32 fold differs in the
last bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import registry
from ..formats import WeightReader
from ..ops import activations as act
from ..ops.layers import Conv1dSpec, _tensor, conv1d_init_state, conv1d_params, conv1d_step
from ..ops.ring import conv1d_w_ctb, dot_ctb, ring_conv_init, ring_conv_step


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    """(reference: parse_config_json, NAM/convnet.cpp:326-339)"""

    channels: int
    dilations: Tuple[int, ...]
    batchnorm: bool
    activation: act.ActivationConfig
    groups: int = 1
    in_channels: int = 1
    out_channels: int = 1


def block_spec(cfg: ConvNetConfig, i: int) -> Conv1dSpec:
    # kernel 2 ("HACK 2 kernel"), bias iff no batchnorm (reference: convnet.cpp:57).
    return Conv1dSpec(
        in_channels=cfg.in_channels if i == 0 else cfg.channels,
        out_channels=cfg.channels,
        kernel_size=2,
        dilation=cfg.dilations[i],
        bias=not cfg.batchnorm,
        groups=cfg.groups,
    )


def build(config: dict, weights: np.ndarray, sample_rate: float, device):
    cfg = ConvNetConfig(
        channels=int(config["channels"]),
        dilations=tuple(int(d) for d in config["dilations"]),
        batchnorm=bool(config["batchnorm"]),
        activation=act.ActivationConfig.from_json(config["activation"]),
        groups=int(config.get("groups", 1)),
        in_channels=int(config.get("in_channels", 1)),
        out_channels=int(config.get("out_channels", 1)),
    )
    reader = WeightReader(weights)
    blocks = []
    for i in range(len(cfg.dilations)):
        bp: Dict[str, Any] = {"conv": conv1d_params(block_spec(cfg, i), reader, device)}
        if cfg.batchnorm:
            d = cfg.channels
            mean = reader.take(d).astype(np.float64)
            var = reader.take(d).astype(np.float64)
            w = reader.take(d).astype(np.float64)
            b = reader.take(d).astype(np.float64)
            eps = reader.take_scalar()
            scale = w / np.sqrt(eps + var)
            loc = b - scale * mean
            bp["bn_scale"] = _tensor(scale.astype(np.float32), device)
            bp["bn_loc"] = _tensor(loc.astype(np.float32), device)
        blocks.append(bp)
    head_w = reader.take(cfg.out_channels * cfg.channels).reshape(cfg.out_channels, cfg.channels)
    head_b = reader.take(cfg.out_channels)
    params = {"blocks": blocks, "head_w": _tensor(head_w.T, device), "head_b": _tensor(head_b, device)}
    reader.assert_exhausted()
    return cfg, params


def _device_of(params) -> torch.device:
    return params["head_b"].device


def init_state(cfg: ConvNetConfig, params, batch: int):
    device = _device_of(params)
    return {"blocks": [conv1d_init_state(block_spec(cfg, i), batch, device) for i in range(len(cfg.dilations))]}


def step(cfg: ConvNetConfig, params, state, x):
    """x: (B, T, in_channels) -> (y, state')
    (reference: ConvNet::process, NAM/convnet.cpp:206-278)."""
    new_blocks = []
    h = x
    for i, bp in enumerate(params["blocks"]):
        h, bs = conv1d_step(block_spec(cfg, i), bp["conv"], state["blocks"][i], h)
        new_blocks.append(bs)
        if cfg.batchnorm:
            h = h * bp["bn_scale"] + bp["bn_loc"]
        h = act.apply(cfg.activation, h)
    y = torch.matmul(h, params["head_w"]) + params["head_b"]
    return y, {"blocks": new_blocks}


def prewarm_samples(cfg: ConvNetConfig, sample_rate: float) -> int:
    """1 + sum of dilations (reference: convnet.cpp:200-203)."""
    return 1 + sum(cfg.dilations)


# -- engine tier (fixed T, ring-chunk conv states, (C, T, B) layout) ----------


def engine_prepare(cfg: ConvNetConfig, params, T: int, batch: int):
    device = _device_of(params)
    eparams = {
        "blocks": [
            {
                "conv": conv1d_w_ctb(block_spec(cfg, i), bp["conv"]),
                **({"bn_scale": bp["bn_scale"], "bn_loc": bp["bn_loc"]} if cfg.batchnorm else {}),
            }
            for i, bp in enumerate(params["blocks"])
        ],
        "head_w": params["head_w"].t().contiguous(),  # (O, C)
        "head_b": params["head_b"],
    }
    state = {"blocks": [ring_conv_init(block_spec(cfg, i), T, batch, device) for i in range(len(cfg.dilations))]}
    return eparams, state


def engine_step(cfg: ConvNetConfig, T: int, eparams, state, x):
    """x: (in_channels, T, B) -> (y (out_channels, T, B), state'). Ring writes
    are in place, so ``state`` is consumed."""
    new_blocks = []
    h = x
    for i, bp in enumerate(eparams["blocks"]):
        h, bs = ring_conv_step(block_spec(cfg, i), T, bp["conv"], state["blocks"][i], h)
        new_blocks.append(bs)
        if cfg.batchnorm:
            h = h * bp["bn_scale"][:, None, None] + bp["bn_loc"][:, None, None]
        h = act.apply(cfg.activation, h, channel_axis=0)
    y = dot_ctb(eparams["head_w"], h) + eparams["head_b"][:, None, None]
    return y, {"blocks": new_blocks}


registry.register_architecture(
    registry.ArchDef(
        name="ConvNet",
        config_cls=ConvNetConfig,
        build=build,
        init_state=init_state,
        step=step,
        prewarm_samples=prewarm_samples,
        in_channels=lambda c: c.in_channels,
        out_channels=lambda c: c.out_channels,
        engine_prepare=engine_prepare,
        engine_step=engine_step,
    )
)
