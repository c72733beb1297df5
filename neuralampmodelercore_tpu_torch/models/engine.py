"""StreamEngine: the serving path — fixed block size, ring states.

The port of ``neuralampmodelercore_tpu.models.engine``. As the reference
pre-allocates for a fixed maxBufferSize at Reset (NAM/dsp.cpp:130-140), the
engine fixes the block size T at construction, keeps conv history in
chunked-FIFO rings with O(T) traffic per block, and prepares its weights once.

    engine = StreamEngine(model, batch=4096, block_size=64)
    state = engine.reset()                    # zero state + exact prewarm
    y, state = engine.process(x, state)       # x: (batch, block_size[, C])

Kernel tiers:
  - "fused": the architecture's hand-written CUDA kernel (ops/cuda/stack.py,
    lstm.py or convnet.py, chosen by ``backend_for``), one launch per block
    (a WaveNet whose condition DSP is an LSTM or a ConvNet runs that
    model's kernel first); on a CPU model it runs the kernel's plain
    version;
  - "torch": the per-op engine step (the architecture's ``engine_step``);
  - "auto": "fused" when the model is on a CUDA device and the kernel's
    ``supports`` passes, else "torch".
The JAX package's names of the two tiers, "pallas" and "xla", are accepted
for "fused" and "torch"; ``kernel`` then reports the port's name.

Semantics are identical to Model.process at the same block size; only the
state layout and traffic differ. A state passed to ``process`` is consumed
(rings are written in place): continue with the returned one.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import registry
from .base import Model

KERNELS = ("auto", "fused", "torch")
#: The JAX package's tier names (its models/engine.py) and the port's tier each stands for.
JAX_KERNELS = {"pallas": "fused", "xla": "torch"}


class StreamEngine:
    def __init__(self, model: Model, batch: int, block_size: int, kernel: str = "auto"):
        kernel = JAX_KERNELS.get(kernel, kernel)
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {'|'.join(KERNELS + tuple(JAX_KERNELS))}, got {kernel!r}")
        self.model = model
        self.batch = int(batch)
        self.block_size = int(block_size)
        self.device = model.device
        use_fused = False
        if kernel != "torch":
            from ..ops.cuda import backend_for

            try:
                backend = backend_for(model.config)
            except NotImplementedError:
                if kernel == "fused":
                    raise
                backend = None
            reason = (
                backend.supports(model.config, self.block_size, self.batch)
                if backend is not None
                else "no kernel for this architecture"
            )
            if kernel == "fused":
                if reason is not None:
                    raise ValueError(f"fused kernel does not support this model: {reason}")
                use_fused = True
            else:
                use_fused = reason is None and self.device.type == "cuda"
        if use_fused:
            self._prepare_fn, self._step_fn = backend.prepare, backend.step
            self.kernel = "fused"
        else:
            self._prepare_fn, self._step_fn = registry.engine_fns(model._arch)
            self.kernel = "torch"
        # Engine-layout weights are built once, at construction.
        self._eparams, _ = self._prepare_fn(model.config, model.params, self.block_size, self.batch)

    @property
    def params(self):
        return self._eparams

    def init_state(self) -> Any:
        _, state = self._prepare_fn(self.model.config, self.model.params, self.block_size, self.batch)
        return state

    def step(self, state, x_ctb: torch.Tensor):
        """Raw step in the engine's (C, T, B) layout: (state, x) -> (y, state')."""
        with torch.no_grad():
            return self._step_fn(self.model.config, self.block_size, self._eparams, state, x_ctb)

    def prewarm_plan(self) -> Tuple[int, int]:
        """(full blocks, remainder samples) that ``prewarm`` runs, as the JAX
        package's engine (engine.py:137-168). Feed-forward architectures run
        ceil(n / T) zero blocks: their state is a function of the last
        receptive-field inputs, so the (< T) zero samples beyond the
        reference's exact count leave it at the same fixed point. Recurrent
        architectures (LSTM) have no such fixed point: they run n // T full
        blocks, then one step of n mod T samples on the same tier, eparams
        and state. The step launches once per block, so a fused engine's
        prewarm makes ``full + (rem > 0)`` kernel launches."""
        n = max(self.model.get_prewarm_samples(), 0)
        full, rem = divmod(n, self.block_size)
        if rem and not registry.arch_for_config(self.model.config).recurrent:
            full, rem = full + 1, 0
        return full, rem

    def prewarm(self, state: Any) -> Any:
        full, rem = self.prewarm_plan()
        cin, B = self.model.num_input_channels, self.batch
        zeros = torch.zeros((cin, self.block_size, B), device=self.device)
        for _ in range(full):
            _, state = self.step(state, zeros)
        if rem:
            with torch.no_grad():
                _, state = self._step_fn(
                    self.model.config, rem, self._eparams, state, torch.zeros((cin, rem, B), device=self.device)
                )
        return state

    def reset(self, prewarm: Optional[bool] = None) -> Any:
        state = self.init_state()
        if self.model.prewarm_on_reset if prewarm is None else prewarm:
            state = self.prewarm(state)
        return state

    def process(self, x: Any, state: Any):
        """Public boundary keeps the (B, T[, C]) convention; the transposes in
        and out of the (C, T, B) layout happen here."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        x = x.to(device=self.device, dtype=torch.float32)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[..., None]
        if x.shape[1] != self.block_size:
            raise ValueError(
                f"StreamEngine is specialised to block_size={self.block_size}; got {x.shape[1]} "
                "frames (use Model.process for variable block sizes)"
            )
        y, state = self.step(state, x.permute(2, 1, 0).contiguous())
        y = y.permute(2, 1, 0)
        if squeeze and y.shape[-1] == 1:
            y = y[..., 0]
        return y, state
