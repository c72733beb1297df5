"""Model wrapper: the user-facing handle around (architecture, config, params).

The port of ``neuralampmodelercore_tpu.models.base`` (reference: ``nam::DSP``,
NAM/dsp.h:70-231). Runtime state is an explicit tree of tensors the caller
threads through the block step:

    model = load_model("model.nam")                        # on "cuda"
    state = model.reset(batch=1024, max_buffer_size=64)     # allocate + prewarm
    y, state = model.process(x, state)                      # x: (B, T[, Cin])
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from ..formats import ModelMetadata
from ..registry import ArchDef

# Default max buffer size used by prewarm when none has been set
# (reference: NAM/dsp.h:25-27).
DEFAULT_MAX_BUFFER_SIZE = 4096

# Thread-local prewarm-on-reset default (reference: thread_local
# gPrewarmOnResetDefault, NAM/dsp.cpp:20,44-53).
_tls = threading.local()


def _get_prewarm_default() -> bool:
    return getattr(_tls, "prewarm_on_reset_default", True)


class ScopedPrewarmOnResetDefault:
    """Temporarily change the thread-local prewarm-on-reset default for newly
    constructed models (reference: NAM/dsp.h:44-57)."""

    def __init__(self, prewarm_on_reset: bool):
        self._new = prewarm_on_reset
        self.previous_prewarm_on_reset = _get_prewarm_default()

    def __enter__(self):
        self.previous_prewarm_on_reset = _get_prewarm_default()
        _tls.prewarm_on_reset_default = self._new
        return self

    def __exit__(self, *exc):
        _tls.prewarm_on_reset_default = self.previous_prewarm_on_reset
        return False


def _first_tensor(tree: Any) -> torch.Tensor:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class Model:
    """A loaded NAM model: static config + parameter tensors + metadata."""

    def __init__(self, arch: ArchDef, config: Any, params: Any, metadata: ModelMetadata, device):
        self._arch = arch
        self.config = config
        self.params = params
        self.metadata = metadata
        self.device = torch.device(device)
        self.prewarm_on_reset: bool = _get_prewarm_default()
        self._max_buffer_size: int = 0
        self._external_sample_rate: Optional[float] = None

    # -- identity / metadata -------------------------------------------------

    @property
    def architecture(self) -> str:
        return self._arch.name

    @property
    def num_input_channels(self) -> int:
        return self._arch.in_channels(self.config)

    @property
    def num_output_channels(self) -> int:
        return self._arch.out_channels(self.config)

    @property
    def expected_sample_rate(self) -> float:
        return self.metadata.sample_rate

    @property
    def max_buffer_size(self) -> int:
        return self._max_buffer_size

    def has_loudness(self) -> bool:
        return self.metadata.loudness is not None

    def get_loudness(self) -> float:
        if self.metadata.loudness is None:
            raise RuntimeError("Model doesn't know its loudness.")
        return self.metadata.loudness

    def has_input_level(self) -> bool:
        return self.metadata.input_level_dbu is not None

    def get_input_level(self) -> float:
        if self.metadata.input_level_dbu is None:
            raise RuntimeError("Model doesn't know its input level.")
        return self.metadata.input_level_dbu

    def has_output_level(self) -> bool:
        return self.metadata.output_level_dbu is not None

    def get_output_level(self) -> float:
        if self.metadata.output_level_dbu is None:
            raise RuntimeError("Model doesn't know its output level.")
        return self.metadata.output_level_dbu

    def set_loudness(self, loudness: float) -> None:
        self.metadata.loudness = float(loudness)

    def set_input_level(self, input_level_dbu: float) -> None:
        self.metadata.input_level_dbu = float(input_level_dbu)

    def set_output_level(self, output_level_dbu: float) -> None:
        self.metadata.output_level_dbu = float(output_level_dbu)

    # -- state management ----------------------------------------------------

    def get_prewarm_samples(self) -> int:
        sr = self._external_sample_rate
        if sr is None:
            sr = self.expected_sample_rate
        return self._arch.prewarm_samples(self.config, sr)

    def init_state(self, batch: int = 1) -> Any:
        """Fresh zero state (no prewarm)."""
        return self._arch.init_state(self.config, self.params, batch)

    def _step(self, state, x):
        with torch.no_grad():
            return self._arch.step(self.config, self.params, state, x)

    def prewarm(self, state: Any, max_buffer_size: Optional[int] = None) -> Any:
        """Settle initial conditions by processing exactly the prewarm sample
        count of zeros: full blocks, then one short remainder block
        (reference: DSP::prewarm, NAM/dsp.cpp:67-101)."""
        n = self.get_prewarm_samples()
        if n <= 0:
            return state
        block = max_buffer_size or self._max_buffer_size or DEFAULT_MAX_BUFFER_SIZE
        first = _first_tensor(state)
        batch = first.shape[0] if first is not None else 1
        cin = self.num_input_channels
        zeros = torch.zeros((batch, block, cin), device=self.device)
        remaining = n
        while remaining >= block:
            _, state = self._step(state, zeros)
            remaining -= block
        if remaining > 0:
            _, state = self._step(state, torch.zeros((batch, remaining, cin), device=self.device))
        return state

    def reset(
        self,
        batch: int = 1,
        sample_rate: Optional[float] = None,
        max_buffer_size: int = DEFAULT_MAX_BUFFER_SIZE,
    ) -> Any:
        """Allocate a fresh state and (by default) prewarm it
        (reference: DSP::Reset, NAM/dsp.cpp:130-140)."""
        if sample_rate is not None:
            self._external_sample_rate = float(sample_rate)
        self._max_buffer_size = int(max_buffer_size)
        state = self.init_state(batch)
        if self.prewarm_on_reset:
            state = self.prewarm(state, max_buffer_size)
        return state

    # -- processing ----------------------------------------------------------

    def _as_input(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
            device=self.device, dtype=torch.float32
        )

    def process(self, x: Any, state: Any):
        """Process one block of any length. x: (B, T, Cin) or (B, T) for mono;
        returns (y, state') with y matching x's channel convention."""
        x = self._as_input(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[..., None]
        y, state = self._step(state, x)
        if squeeze and y.shape[-1] == 1:
            y = y[..., 0]
        return y, state

    def render(self, x: Any, prewarm: bool = True):
        """Offline full-sequence render: fresh state, optional prewarm, then the
        whole signal in one step. x: (T,), (B, T) or (B, T, C); same rank out."""
        x = self._as_input(x)
        orig_ndim = x.dim()
        if orig_ndim == 1:
            x = x[None, :, None]
        elif orig_ndim == 2:
            x = x[..., None]
        batch = x.shape[0]
        state = self.init_state(batch)
        if prewarm and self.prewarm_on_reset:
            n = self.get_prewarm_samples()
            if n > 0:
                zeros = torch.zeros((batch, n, self.num_input_channels), device=self.device)
                _, state = self._step(state, zeros)
        y, _ = self._step(state, x)
        if orig_ndim == 1:
            return y[0, :, 0]
        if orig_ndim == 2:
            return y[..., 0]
        return y

    def num_params(self) -> int:
        count = 0
        stack = [self.params]
        while stack:
            v = stack.pop()
            if isinstance(v, torch.Tensor):
                count += v.numel()
            elif isinstance(v, dict):
                stack.extend(v.values())
            elif isinstance(v, (list, tuple)):
                stack.extend(v)
        return count
