"""LSTM: multi-layer LSTM with a linear head.

The port of ``neuralampmodelercore_tpu.models.lstm`` (reference:
NAM/lstm.{h,cpp}). The recurrence is a Python loop over the block's frames;
each cell update is one batched matmul over all streams. The fused tier runs
the whole block in one hand-written CUDA kernel (ops/cuda/lstm.py).

Weight-stream contract (reference: NAM/lstm.cpp:9-29, 82-98):
  per layer: W (4H x (input+H)) row-major, b (4H), then INITIAL h (H), then
  INITIAL c (H); afterwards head W (out x H) row-major, then head bias (out).
  Gate order within the 4H axis: i, f, g, o.

Cell math (reference: NAM/lstm.cpp:31-68):
  ifgo = W @ [x; h] + b
  c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
  h' = sigmoid(o) * tanh(c')
When global fast-tanh mode is on, the cell uses fast_sigmoid/fast_tanh
(reference: NAM/lstm.cpp:48-58).

The state is not a function of the last few inputs, so the architecture is
registered ``recurrent``: the engine's prewarm runs the exact sample count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import registry
from ..formats import WeightReader
from ..ops import activations as act
from ..ops.layers import _tensor


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    """(reference: LSTMConfig, NAM/lstm.h + parse_config_json lstm.cpp:171-181)"""

    num_layers: int
    input_size: int
    hidden_size: int
    in_channels: int = 1
    out_channels: int = 1


def build(config: dict, weights: np.ndarray, sample_rate: float, device):
    cfg = LSTMConfig(
        num_layers=int(config["num_layers"]),
        input_size=int(config["input_size"]),
        hidden_size=int(config["hidden_size"]),
        in_channels=int(config.get("in_channels", 1)),
        out_channels=int(config.get("out_channels", 1)),
    )
    reader = WeightReader(weights)
    H = cfg.hidden_size
    layers = []
    for li in range(cfg.num_layers):
        isz = cfg.input_size if li == 0 else H
        w = reader.take(4 * H * (isz + H)).reshape(4 * H, isz + H)  # row-major
        b = reader.take(4 * H)
        h0 = reader.take(H)
        c0 = reader.take(H)
        # w stored transposed, (I+H, 4H), for xh @ w (the JAX package's layout).
        layers.append({"w": _tensor(w.T, device), "b": _tensor(b, device),
                       "h0": _tensor(h0, device), "c0": _tensor(c0, device)})
    head_w = reader.take(cfg.out_channels * H).reshape(cfg.out_channels, H)
    head_b = reader.take(cfg.out_channels)
    params = {"layers": layers, "head_w": _tensor(head_w.T, device), "head_b": _tensor(head_b, device)}
    reader.assert_exhausted()
    return cfg, params


def init_state(cfg: LSTMConfig, params, batch: int):
    """Initial h and c are part of the weight stream (reference: lstm.cpp:24-28),
    broadcast across the batch of streams."""
    return {
        "h": [l["h0"].expand(batch, cfg.hidden_size).clone() for l in params["layers"]],
        "c": [l["c0"].expand(batch, cfg.hidden_size).clone() for l in params["layers"]],
    }


def cell_update(ifgo: torch.Tensor, c: torch.Tensor, H: int, axis: int):
    """Gate nonlinearities and the state update, gates i, f, g, o along
    ``axis``; fast_sigmoid / fast_tanh in fast-tanh mode."""
    sig, th = (act.fast_sigmoid, act.fast_tanh) if act.using_fast_tanh else (torch.sigmoid, torch.tanh)
    i, f, g, o = ifgo.split(H, dim=axis)
    c_new = sig(f) * c + sig(i) * th(g)
    h_new = sig(o) * th(c_new)
    return h_new, c_new


def _passthrough(cfg: LSTMConfig, x: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """num_layers == 0 copies the first min(in, out) channels (reference:
    lstm.cpp:141-151)."""
    shape = list(x.shape)
    shape[channel_axis] = cfg.out_channels
    y = torch.zeros(shape, dtype=x.dtype, device=x.device)
    n = min(cfg.in_channels, cfg.out_channels)
    y.narrow(channel_axis, 0, n).copy_(x.narrow(channel_axis, 0, n))
    return y


def step(cfg: LSTMConfig, params, state, x):
    """x: (B, T, in_channels) -> (y (B, T, out_channels), state').

    The reference's per-sample loop (lstm.cpp:103-125). in_channels maps onto
    the cell input (input_size == in_channels for all known models)."""
    if cfg.num_layers == 0:
        return _passthrough(cfg, x, -1), state
    H = cfg.hidden_size
    hs, cs = list(state["h"]), list(state["c"])
    ys = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        for li, lp in enumerate(params["layers"]):
            ifgo = torch.matmul(torch.cat([inp, hs[li]], dim=-1), lp["w"]) + lp["b"]
            hs[li], cs[li] = cell_update(ifgo, cs[li], H, -1)
            inp = hs[li]
        ys.append(torch.matmul(inp, params["head_w"]) + params["head_b"])
    return torch.stack(ys, dim=1), {"h": hs, "c": cs}


def prewarm_samples(cfg: LSTMConfig, sample_rate: float) -> int:
    """Half a second of samples (reference: lstm.cpp:127-134)."""
    n = int(0.5 * sample_rate)
    return n if n > 0 else 1


# -- engine tier ((H, B) layout: streams innermost) ---------------------------


def engine_prepare(cfg: LSTMConfig, params, T: int, batch: int):
    """Weights as (4H, I+H) and (O, H); state h, c per layer as (H, B). Neither
    depends on T, so one state serves any block size (the exact remainder
    prewarm needs that)."""
    eparams = {
        "layers": [{"w": l["w"].t().contiguous(), "b": l["b"]} for l in params["layers"]],
        "head_w": params["head_w"].t().contiguous(),
        "head_b": params["head_b"],
    }
    state = {
        "h": [l["h0"][:, None].expand(cfg.hidden_size, batch).clone() for l in params["layers"]],
        "c": [l["c0"][:, None].expand(cfg.hidden_size, batch).clone() for l in params["layers"]],
    }
    return eparams, state


def engine_step(cfg: LSTMConfig, T: int, eparams, state, x):
    """x: (C, T', B) -> (y (O, T', B), state'), for any T' (the remainder
    prewarm step passes a shorter block). Cell products run with the stream
    batch innermost: (4H, I+H) @ (I+H, B)."""
    if cfg.num_layers == 0:
        return _passthrough(cfg, x, 0), state
    H = cfg.hidden_size
    hs, cs = list(state["h"]), list(state["c"])
    tops = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        for li, lp in enumerate(eparams["layers"]):
            ifgo = torch.matmul(lp["w"], torch.cat([inp, hs[li]], dim=0)) + lp["b"][:, None]
            hs[li], cs[li] = cell_update(ifgo, cs[li], H, 0)
            inp = hs[li]
        tops.append(inp)
    h_all = torch.stack(tops, dim=1)  # (H, T', B)
    Tn, B = x.shape[1], x.shape[2]
    y = torch.matmul(eparams["head_w"], h_all.reshape(H, Tn * B)).view(-1, Tn, B)
    return y + eparams["head_b"][:, None, None], {"h": hs, "c": cs}


registry.register_architecture(
    registry.ArchDef(
        name="LSTM",
        config_cls=LSTMConfig,
        build=build,
        init_state=init_state,
        step=step,
        prewarm_samples=prewarm_samples,
        in_channels=lambda c: c.in_channels,
        out_channels=lambda c: c.out_channels,
        engine_prepare=engine_prepare,
        engine_step=engine_step,
        recurrent=True,
    )
)
