"""Activation functions and their configuration.

The port of ``neuralampmodelercore_tpu.ops.activations`` (reference:
NAM/activations.{h,cpp}). Every activation is an elementwise torch function
applied to whole blocks.

  - 11 activation types + Identity (reference: NAM/activations.h:27-40)
  - string-or-object JSON config parsing (reference: NAM/activations.cpp:59-130)
  - global fast-tanh mode: "Tanh" -> rational ``fast_tanh``
    (reference: NAM/activations.cpp:168-187)
  - LUT mode replacing Tanh/Sigmoid/SiLU with a clamped linear-interpolation
    table (reference: FastLUTActivation, NAM/activations.h:374-425). The
    values are those of the JAX package's ``_lut_apply``: the base function is
    evaluated at the two bracketing grid points.

The two modes are process-wide, as in the reference and the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

JSON = Union[str, dict]

_SIMPLE_TYPES = (
    "Tanh",
    "Hardtanh",
    "Fasttanh",
    "ReLU",
    "Sigmoid",
    "SiLU",
    "Hardswish",
    "Softsign",
)

# Both casings accepted (reference: NAM/activations.cpp:74-75).
_NAME_ALIASES = {"LeakyHardTanh": "LeakyHardtanh"}

_ALL_TYPES = frozenset(_SIMPLE_TYPES) | {"LeakyReLU", "PReLU", "LeakyHardtanh"}


@dataclasses.dataclass(frozen=True)
class ActivationConfig:
    """Typed activation configuration (reference: NAM/activations.h:43-58)."""

    type: str = "Identity"
    negative_slope: Optional[float] = None  # LeakyReLU / PReLU (single)
    negative_slopes: Optional[Tuple[float, ...]] = None  # PReLU (per-channel)
    min_val: Optional[float] = None  # LeakyHardtanh
    max_val: Optional[float] = None
    min_slope: Optional[float] = None
    max_slope: Optional[float] = None

    @staticmethod
    def simple(type_name: str) -> "ActivationConfig":
        return ActivationConfig(type=type_name)

    @staticmethod
    def from_json(j: JSON) -> "ActivationConfig":
        """Parse a string or {"type": ..., params} object
        (reference: NAM/activations.cpp:59-130)."""
        if isinstance(j, str):
            name = _NAME_ALIASES.get(j, j)
            if name not in _ALL_TYPES:
                raise ValueError(f"Unknown activation type: {j}")
            return ActivationConfig(type=name)
        if isinstance(j, dict):
            type_str = j["type"]
            name = _NAME_ALIASES.get(type_str, type_str)
            if name not in _ALL_TYPES:
                raise ValueError(f"Unknown activation type: {type_str}")
            cfg = {"type": name}
            if name == "PReLU":
                if "negative_slope" in j:
                    cfg["negative_slope"] = float(j["negative_slope"])
                elif "negative_slopes" in j:
                    cfg["negative_slopes"] = tuple(float(v) for v in j["negative_slopes"])
            elif name == "LeakyReLU":
                cfg["negative_slope"] = float(j.get("negative_slope", 0.01))
            elif name == "LeakyHardtanh":
                cfg["min_val"] = float(j.get("min_val", -1.0))
                cfg["max_val"] = float(j.get("max_val", 1.0))
                cfg["min_slope"] = float(j.get("min_slope", 0.01))
                cfg["max_slope"] = float(j.get("max_slope", 0.01))
            return ActivationConfig(**cfg)
        raise ValueError("Invalid activation config: expected string or object")


# =============================================================================
# Elementwise math
# =============================================================================


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Rational tanh approximation (reference: NAM/activations.h:91-98)."""
    ax = torch.abs(x)
    x2 = x * x
    num = x * (2.45550750702956 + 2.45550750702956 * ax + (0.893229853513558 + 0.821226666969744 * ax) * x2)
    den = 2.44506634652299 + (2.44506634652299 + x2) * torch.abs(x + 0.814642734961073 * x * ax)
    return num / den


def fast_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """(reference: NAM/activations.h:100-103)"""
    return 0.5 * (fast_tanh(x * 0.5) + 1.0)


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1.0, 1.0)


def leaky_hardtanh(x, min_val, max_val, min_slope, max_slope):
    """(reference: NAM/activations.h:75-89)"""
    below = (x - min_val) * min_slope + min_val
    above = (x - max_val) * max_slope + max_val
    return torch.where(x < min_val, below, torch.where(x > max_val, above, x))


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * clamp(x+3, 0, 6) / 6 (reference: NAM/activations.h:120-128)."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.abs(x))


# =============================================================================
# Global modes: fast-tanh and LUT (reference: NAM/activations.cpp:168-232)
# =============================================================================

using_fast_tanh: bool = False

# name -> (min, max, n_points); replaces Tanh / Sigmoid / SiLU.
_luts: Dict[str, Tuple[float, float, int]] = {}

_LUT_FNS = {
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "SiLU": lambda x: x * torch.sigmoid(x),
}


def enable_fast_tanh() -> None:
    """Rebind "Tanh" to the fast rational approximation
    (reference: NAM/activations.cpp:168-187)."""
    global using_fast_tanh
    using_fast_tanh = True


def disable_fast_tanh() -> None:
    global using_fast_tanh
    using_fast_tanh = False


def enable_lut(function_name: str, min_x: float, max_x: float, n_points: int) -> None:
    """Replace an activation with a linear-interpolation lookup table
    (reference: NAM/activations.cpp:189-232)."""
    if function_name not in _LUT_FNS:
        raise ValueError(f"LUT not supported for activation: {function_name}")
    if n_points < 2:
        raise ValueError("LUT needs at least 2 points")
    _luts[function_name] = (float(min_x), float(max_x), int(n_points))


def disable_lut(function_name: str) -> None:
    _luts.pop(function_name, None)


def lut_active() -> bool:
    return bool(_luts)


def modes() -> Tuple[bool, Tuple]:
    """The global modes as one comparable value: a kernel bakes them in when
    its weights are prepared, and its step checks they have not changed."""
    return using_fast_tanh, tuple(sorted(_luts.items()))


def _lut_apply(x: torch.Tensor, min_x: float, max_x: float, n: int, fn_name: str) -> torch.Tensor:
    """Clamped uniform-grid linear-interpolation lookup
    (reference: FastLUTActivation::apply, NAM/activations.h:393-410), with
    the table entries recomputed at the two bracketing grid points."""
    step = (max_x - min_x) / (n - 1)
    return _lut_interp(x, min_x, max_x, 1.0 / step, step, n - 1, _LUT_FNS[fn_name])


def _lut_interp(x, min_x, max_x, inv_step, step, n_minus_1, fn) -> torch.Tensor:
    """``_lut_apply``'s arithmetic on its float32 constants (scalars are cast
    to x's float32 by torch, as the kernels receive them)."""
    xc = torch.clamp(x, min_x, max_x)
    f_idx = (xc - min_x) * inv_step
    i = torch.clamp(f_idx.to(torch.int32), 0, int(n_minus_1) - 1)
    fi = i.to(x.dtype)
    frac = f_idx - fi
    g0 = min_x + fi * step
    y0 = fn(g0)
    y1 = fn(g0 + step)
    y = y0 + (y1 - y0) * frac
    # Edge case at max (reference: NAM/activations.h:403-405).
    return torch.where(f_idx >= n_minus_1, fn(torch.full_like(x, max_x)), y)


# =============================================================================
# What the port's kernels run: a code and float32 parameters per activation
# =============================================================================

#: Codes of the ``Act`` enum in csrc/activations.cuh (11 is stack.cu's
#: per-channel PReLU); LUT codes take the base function of the table.
KERNEL_CODES = {
    "Identity": 0, "Tanh": 1, "ReLU": 2, "Sigmoid": 3, "Hardtanh": 4,
    "LeakyReLU": 5, "PReLU": 5, "SiLU": 6, "Softsign": 7, "Hardswish": 8,
    "Fasttanh": 9, "LeakyHardtanh": 10,
}
LUT_CODES = {"Tanh": 12, "Sigmoid": 13, "SiLU": 14}
KERNEL_PARAMS = 8  # parameter floats a kernel reads for one activation


def kernel_code(config: "ActivationConfig") -> Tuple[int, np.ndarray]:
    """The activation as a kernel runs it under the current global modes:
    its code and KERNEL_PARAMS float32 parameters, with ``apply``'s
    precedence. Tanh: fast-tanh, else a Tanh LUT, else tanh. Sigmoid: only a
    Sigmoid LUT changes it (fast-tanh does not rebind Sigmoid). SiLU: only a
    SiLU LUT. A LUT's parameters are min_x, max_x, 1/step, step and n - 1, as
    the float32 values ``_lut_apply`` computes with."""
    t = config.type
    prm = np.zeros(KERNEL_PARAMS, np.float32)
    if t == "Tanh" and using_fast_tanh:
        return KERNEL_CODES["Fasttanh"], prm
    if t in _luts:
        min_x, max_x, n = _luts[t]
        step = (max_x - min_x) / (n - 1)
        prm[:5] = [min_x, max_x, 1.0 / step, step, n - 1]
        return LUT_CODES[t], prm
    if t in ("LeakyReLU", "PReLU"):
        prm[0] = prelu_slopes(config)[0] if t == "PReLU" else (
            config.negative_slope if config.negative_slope is not None else 0.01)
    elif t == "LeakyHardtanh":
        prm[:4] = [
            config.min_val if config.min_val is not None else -1.0,
            config.max_val if config.max_val is not None else 1.0,
            config.min_slope if config.min_slope is not None else 0.01,
            config.max_slope if config.max_slope is not None else 0.01,
        ]
    return KERNEL_CODES[t], prm


_KERNEL_FNS = {
    KERNEL_CODES["Tanh"]: torch.tanh,
    KERNEL_CODES["ReLU"]: lambda v: torch.clamp_min(v, 0.0),
    KERNEL_CODES["Sigmoid"]: torch.sigmoid,
    KERNEL_CODES["Hardtanh"]: hard_tanh,
    KERNEL_CODES["SiLU"]: _LUT_FNS["SiLU"],
    KERNEL_CODES["Softsign"]: softsign,
    KERNEL_CODES["Hardswish"]: hardswish,
    KERNEL_CODES["Fasttanh"]: fast_tanh,
}


def kernel_apply(code: int, prm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A kernel's activation ``code`` with its parameters ``prm`` (float32,
    at least KERNEL_PARAMS), in torch: the plain versions' activation."""
    if code in _KERNEL_FNS:
        return _KERNEL_FNS[code](v)
    if code == KERNEL_CODES["LeakyReLU"]:
        return torch.where(v > 0, v, prm[0] * v)
    if code == KERNEL_CODES["LeakyHardtanh"]:
        return leaky_hardtanh(v, prm[0], prm[1], prm[2], prm[3])
    for name, lut in LUT_CODES.items():
        if code == lut:
            return _lut_interp(v, *(float(p) for p in prm[:5]), _LUT_FNS[name])
    return v  # Identity


# =============================================================================
# Application
# =============================================================================


def prelu_slopes(config: ActivationConfig) -> Tuple[float, ...]:
    if config.negative_slopes is not None:
        return tuple(float(s) for s in config.negative_slopes)
    if config.negative_slope is not None:
        return (float(config.negative_slope),)
    return (0.01,)


def apply(config: ActivationConfig, x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Apply an activation to x. PReLU indexes its slopes along
    ``channel_axis`` (default trailing, as the reference's channel-fastest
    layout, NAM/activations.h:282-298; the (C, T, B) engine layout passes 0)."""
    t = config.type
    if t == "Identity":
        return x
    if t == "Tanh":
        if using_fast_tanh:
            return fast_tanh(x)
        if "Tanh" in _luts:
            return _lut_apply(x, *_luts["Tanh"], "Tanh")
        return torch.tanh(x)
    if t == "Hardtanh":
        return hard_tanh(x)
    if t == "Fasttanh":
        return fast_tanh(x)
    if t == "ReLU":
        return torch.clamp_min(x, 0.0)
    if t == "LeakyReLU":
        ns = config.negative_slope if config.negative_slope is not None else 0.01
        return torch.where(x > 0, x, ns * x)
    if t == "PReLU":
        slopes = prelu_slopes(config)
        ax = channel_axis % x.dim()
        c = x.shape[ax]
        n = len(slopes)
        if c % n != 0:
            raise ValueError(
                f"PReLU got {c} channels but activation has {n} slopes, which doesn't divide evenly."
            )
        if n == 1:
            return torch.where(x > 0, x, slopes[0] * x)
        # The reference indexes pos % n_slopes with channels fastest
        # (NAM/activations.h:293-297).
        s = torch.tensor(slopes, dtype=x.dtype, device=x.device).repeat(c // n)
        shape = [1] * x.dim()
        shape[ax] = c
        return torch.where(x > 0, x, s.reshape(shape) * x)
    if t == "Sigmoid":
        # enable_fast_tanh does not rebind the standalone Sigmoid activation
        # (NAM/activations.cpp:168-187).
        if "Sigmoid" in _luts:
            return _lut_apply(x, *_luts["Sigmoid"], "Sigmoid")
        return torch.sigmoid(x)
    if t == "SiLU":
        if "SiLU" in _luts:
            return _lut_apply(x, *_luts["SiLU"], "SiLU")
        return x * torch.sigmoid(x)
    if t == "Hardswish":
        return hardswish(x)
    if t == "Softsign":
        return softsign(x)
    if t == "LeakyHardtanh":
        return leaky_hardtanh(
            x,
            config.min_val if config.min_val is not None else -1.0,
            config.max_val if config.max_val is not None else 1.0,
            config.min_slope if config.min_slope is not None else 0.01,
            config.max_slope if config.max_slope is not None else 0.01,
        )
    raise ValueError(f"Unknown activation type: {t}")
