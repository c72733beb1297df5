"""Primitive NN ops: Conv1x1, streaming dilated Conv1D, FiLM, gating/blending.

The port of ``neuralampmodelercore_tpu.ops.layers`` (reference: NAM/dsp.{h,cpp}
Conv1x1, NAM/conv1d.{h,cpp}, NAM/film.h, NAM/gating_activations.h).

  - Layout is (batch, time, channels) for the generic tier.
  - The reference's per-layer RingBuffer becomes carried halo state: a
    (batch, receptive_field, in_channels) tensor concatenated in front of each
    incoming block (the ``RingBuffer::Read(n, lookback)`` contract).
  - Grouped convs keep dense block-diagonal weights and run one matmul, as the
    reference does (NAM/dsp.cpp:426-428).
  - Every product is float32: the package refuses TF32 at import.

Parameters are dicts of tensors on the device passed to the builders.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..formats import WeightReader
from . import activations as _act

Params = Dict[str, Any]

#: The names set_matmul_precision accepts: both name float32-exact products.
MATMUL_PRECISIONS = ("highest", "float32")


def set_matmul_precision(precision: str) -> None:
    """The JAX package's precision switch (its ops/layers.py). The port is
    float32-exact (ROADMAP North star: no TF32, no single-pass or bf16
    products), so it takes only the names of that precision, "highest" and
    "float32" (any case), and holds torch's float32 matmuls at "highest";
    every other name ("high", "bfloat16_3x", "default", "bfloat16", ...)
    raises ValueError."""
    if not isinstance(precision, str) or precision.lower() not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {precision!r}: the port is float32-exact and takes only "
                         f"{' or '.join(MATMUL_PRECISIONS)} (no TF32, no bfloat16 passes)")
    torch.set_float32_matmul_precision("highest")


def _validate_groups(in_channels: int, out_channels: int, groups: int) -> None:
    """(reference: NAM/dsp.cpp:313-323, NAM/conv1d.cpp:59-69)"""
    if in_channels % groups != 0:
        raise ValueError(f"in_channels ({in_channels}) must be divisible by numGroups ({groups})")
    if out_channels % groups != 0:
        raise ValueError(f"out_channels ({out_channels}) must be divisible by numGroups ({groups})")


def _is_depthwise(in_channels: int, out_channels: int, groups: int) -> bool:
    """Depthwise := groups == in == out (reference: NAM/dsp.cpp:331, conv1d.cpp:77)."""
    return groups == in_channels and in_channels == out_channels


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)


# =============================================================================
# Conv1x1: pointwise linear layer
# =============================================================================


@dataclasses.dataclass(frozen=True)
class Conv1x1Spec:
    """Static config of a 1x1 conv (reference: nam::Conv1x1, NAM/dsp.h:273-340)."""

    in_channels: int
    out_channels: int
    bias: bool
    groups: int = 1

    @property
    def depthwise(self) -> bool:
        return _is_depthwise(self.in_channels, self.out_channels, self.groups)

    @property
    def num_weights(self) -> int:
        if self.depthwise:
            n = self.in_channels
        else:
            n = (self.out_channels // self.groups) * (self.in_channels // self.groups) * self.groups
        return n + (self.out_channels if self.bias else 0)


def conv1x1_params(spec: Conv1x1Spec, reader: WeightReader, device) -> Params:
    """Consume weights in reference order (NAM/dsp.cpp:363-398): depthwise,
    one weight per channel; grouped, per group (out_pg, in_pg) row-major;
    then bias. ``w`` is stored (in, out) so apply is ``x @ w``."""
    _validate_groups(spec.in_channels, spec.out_channels, spec.groups)
    p: Params = {}
    if spec.depthwise:
        p["dw"] = _tensor(reader.take(spec.in_channels), device)
    else:
        out_pg = spec.out_channels // spec.groups
        in_pg = spec.in_channels // spec.groups
        w = np.zeros((spec.in_channels, spec.out_channels), dtype=np.float32)
        for g in range(spec.groups):
            block = reader.take(out_pg * in_pg).reshape(out_pg, in_pg)
            w[g * in_pg : (g + 1) * in_pg, g * out_pg : (g + 1) * out_pg] = block.T
        p["w"] = _tensor(w, device)
    if spec.bias:
        p["b"] = _tensor(reader.take(spec.out_channels), device)
    return p


def conv1x1_apply(spec: Conv1x1Spec, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_channels) -> (..., out_channels) (reference: NAM/dsp.cpp:414-434)."""
    y = x * p["dw"] if spec.depthwise else torch.matmul(x, p["w"])
    if spec.bias:
        y = y + p["b"]
    return y


# =============================================================================
# Conv1D: streaming dilated causal conv
# =============================================================================


@dataclasses.dataclass(frozen=True)
class Conv1dSpec:
    """Static config of a dilated causal conv (reference: nam::Conv1D,
    NAM/conv1d.h:14-136)."""

    in_channels: int
    out_channels: int
    kernel_size: int
    dilation: int
    bias: bool
    groups: int = 1

    @property
    def depthwise(self) -> bool:
        return _is_depthwise(self.in_channels, self.out_channels, self.groups)

    @property
    def receptive_field(self) -> int:
        """Zero-indexed lookback (K-1)*dilation (reference: NAM/conv1d.cpp:129)."""
        return (self.kernel_size - 1) * self.dilation if self.kernel_size > 0 else 0

    @property
    def num_weights(self) -> int:
        if self.depthwise:
            n = self.in_channels * self.kernel_size
        else:
            n = (
                (self.out_channels // self.groups)
                * (self.in_channels // self.groups)
                * self.kernel_size
                * self.groups
            )
        return n + (self.out_channels if self.bias else 0)


def conv1d_params(spec: Conv1dSpec, reader: WeightReader, device) -> Params:
    """Consume weights in reference order (NAM/conv1d.cpp:10-54): depthwise,
    for each channel for each tap; grouped, for g, out i, in j, tap k; then
    bias. ``w`` is stored (K, in, out); depthwise ``dw`` is stored (K, C)."""
    _validate_groups(spec.in_channels, spec.out_channels, spec.groups)
    K = spec.kernel_size
    p: Params = {}
    if spec.depthwise:
        dw = reader.take(spec.in_channels * K).reshape(spec.in_channels, K)
        p["dw"] = _tensor(dw.T, device)
    else:
        out_pg = spec.out_channels // spec.groups
        in_pg = spec.in_channels // spec.groups
        w = np.zeros((K, spec.in_channels, spec.out_channels), dtype=np.float32)
        for g in range(spec.groups):
            block = reader.take(out_pg * in_pg * K).reshape(out_pg, in_pg, K)
            w[:, g * in_pg : (g + 1) * in_pg, g * out_pg : (g + 1) * out_pg] = block.transpose(2, 1, 0)
        p["w"] = _tensor(w, device)
    if spec.bias:
        p["b"] = _tensor(reader.take(spec.out_channels), device)
    return p


def conv1d_init_state(spec: Conv1dSpec, batch: int, device) -> torch.Tensor:
    """Zero halo history (batch, receptive_field, in_channels), the reset
    RingBuffer of the reference (NAM/ring_buffer.cpp:17-27)."""
    return torch.zeros((batch, spec.receptive_field, spec.in_channels), device=device)


def conv1d_apply_full(spec: Conv1dSpec, p: Params, full: torch.Tensor) -> torch.Tensor:
    """Convolve a block that has its halo prepended: full (B, rf + T, Cin) ->
    (B, T, Cout). Tap k reads at lookback dilation*(K-1-k)
    (reference: NAM/conv1d.cpp:244-252)."""
    K, d, rf = spec.kernel_size, spec.dilation, spec.receptive_field
    T = full.shape[1] - rf
    y = None
    for k in range(K):
        start = rf - (K - 1 - k) * d
        xk = full[:, start : start + T]
        contrib = xk * p["dw"][k] if spec.depthwise else torch.matmul(xk, p["w"][k])
        y = contrib if y is None else y + contrib
    if spec.bias:
        y = y + p["b"]
    return y


def conv1d_step(spec: Conv1dSpec, p: Params, state: torch.Tensor, x: torch.Tensor):
    """Streaming step: (state (B, rf, Cin), x (B, T, Cin)) -> (y (B, T, Cout),
    state'). RingBuffer::Write + per-tap Read + Advance (NAM/conv1d.cpp:146-257)."""
    rf = spec.receptive_field
    if rf == 0:
        return conv1d_apply_full(spec, p, x), state
    full = torch.cat([state, x], dim=1)
    y = conv1d_apply_full(spec, p, full)
    return y, full[:, x.shape[1] :].contiguous()


# =============================================================================
# FiLM: feature-wise linear modulation
# =============================================================================


@dataclasses.dataclass(frozen=True)
class FiLMSpec:
    """(reference: nam::FiLM, NAM/film.h:20-210)"""

    condition_dim: int
    input_dim: int
    shift: bool
    groups: int = 1

    @property
    def cond_spec(self) -> Conv1x1Spec:
        # condition -> (shift ? 2 : 1) * input_dim, with bias (NAM/film.h:28-31).
        return Conv1x1Spec(
            in_channels=self.condition_dim,
            out_channels=(2 if self.shift else 1) * self.input_dim,
            bias=True,
            groups=self.groups,
        )

    @property
    def num_weights(self) -> int:
        return self.cond_spec.num_weights


def film_params(spec: FiLMSpec, reader: WeightReader, device) -> Params:
    return conv1x1_params(spec.cond_spec, reader, device)


def film_apply(spec: FiLMSpec, p: Params, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
    """out = x * scale (+ shift); scale/shift are the two halves of
    Conv1x1(condition) (reference: NAM/film.h:76-190)."""
    ss = conv1x1_apply(spec.cond_spec, p, condition)
    if spec.shift:
        return x * ss[..., : spec.input_dim] + ss[..., spec.input_dim :]
    return x * ss


# =============================================================================
# Gating / blending activations (consume 2C channels -> C)
# =============================================================================


def gated_apply(
    primary: _act.ActivationConfig,
    secondary: _act.ActivationConfig,
    z: torch.Tensor,
    bottleneck: int,
) -> torch.Tensor:
    """GATED: act1(top) * act2(bottom) (reference: NAM/gating_activations.h:59-114)."""
    return _act.apply(primary, z[..., :bottleneck]) * _act.apply(secondary, z[..., bottleneck:])


def blended_apply(
    primary: _act.ActivationConfig,
    secondary: _act.ActivationConfig,
    z: torch.Tensor,
    bottleneck: int,
) -> torch.Tensor:
    """BLENDED: alpha*act1(top) + (1-alpha)*top with alpha = act2(bottom)
    (reference: NAM/gating_activations.h:165-228)."""
    top = z[..., :bottleneck]
    alpha = _act.apply(secondary, z[..., bottleneck:])
    return alpha * _act.apply(primary, top) + (1.0 - alpha) * top
