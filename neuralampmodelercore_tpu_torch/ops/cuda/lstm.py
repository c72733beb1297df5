"""Fused LSTM block step: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_make_kernel`` of ``neuralampmodelercore_tpu/ops/
pallas/lstm.py`` (its ``step`` reaches ``pl.pallas_call`` at lstm.py:208),
K2 in ROADMAP.md: the whole T-frame recurrence of every layer, and the head,
in one launch, with h and c updated in place. The kernel is ``csrc/lstm.cu``;
its header says what bounds it on an H100 and how the design answers that.

Engine-facing API (mirrors ``models.lstm.engine_prepare/engine_step``):

    reason = supports(cfg, T, batch)       # None, or why the kernel refuses
    eparams, state = prepare(cfg, params, T, batch)
    y, state = step(cfg, T, eparams, state, x)   # x (Cin, T', B) -> y (O, T', B)

The state is {"h", "c"}, each (L, H, B), streams innermost. Neither it nor
the packed weights depend on T, so ``step`` takes any block length T' >= 1:
the engine's exact prewarm runs its remainder through the same kernel.
Global fast-tanh mode is read at each launch and passed as a flag.

On a CUDA tensor ``step`` launches the kernel (or raises); on a CPU tensor it
runs ``step_plain``, the same step on the same layout in plain torch.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import activations as act
from . import _build
from .stack import SMEM_LIMIT, _np

#: Kernel launches so far; ``step_plain`` does not count.
launches = 0

MAX_IN = 4  # input channels, MAX_IN in lstm.cu
HP_TILES = (4, 8, 16, 32)  # padded hidden widths with a kernel instance
#: h of every layer lives in registers for the whole block: L * HP floats a
#: thread, at most 128 of its 255 registers (c is in shared memory). lstm.cu
#: has an instance for every (HP, L) in HP_TILES x 1..MAX_LAYERS.
MAX_LAYERS = 4
THREADS = 64  # streams per CTA, THREADS in lstm.cu


def _pad_hidden(H: int) -> int:
    for p in HP_TILES:
        if H <= p:
            return p
    raise ValueError(f"hidden_size {H} > {HP_TILES[-1]}")


def _n_weights(cfg, HP: int) -> int:
    """Floats of the packed weights (a multiple of 4)."""
    rows = HP * (1 + cfg.in_channels + HP) + (cfg.num_layers - 1) * HP * (1 + 2 * HP)
    return 4 * rows + cfg.out_channels * HP + -(-cfg.out_channels // 4) * 4


def _smem_bytes(cfg, HP: int) -> int:
    """The weights, then c and the new h of every thread of the CTA."""
    return 4 * (_n_weights(cfg, HP) + (cfg.num_layers + 1) * HP * THREADS)


# =============================================================================
# Gate
# =============================================================================


def supports(cfg, T: int, batch: int) -> Optional[str]:
    """None if the kernel runs this (config, block size, batch), else why not.
    Any batch (the ragged last CTA is masked) and any T >= 1."""
    from ...models.lstm import LSTMConfig

    if not isinstance(cfg, LSTMConfig):
        return f"not an LSTMConfig: {type(cfg).__name__}"
    if batch < 1:
        return f"batch {batch} < 1"
    if T < 1:
        return f"block size T={T} < 1"
    if cfg.num_layers < 1:
        return "passthrough LSTM (num_layers == 0): no recurrence to run"
    if cfg.input_size != cfg.in_channels:
        return f"input_size {cfg.input_size} != in_channels {cfg.in_channels}"
    if cfg.in_channels > MAX_IN:
        return f"in_channels {cfg.in_channels} > {MAX_IN}"
    if cfg.hidden_size > HP_TILES[-1]:
        return f"hidden_size {cfg.hidden_size} > {HP_TILES[-1]} (h lives in registers)"
    if cfg.num_layers > MAX_LAYERS:
        return f"{cfg.num_layers} layers > {MAX_LAYERS}: h of every layer lives in registers"
    HP = _pad_hidden(cfg.hidden_size)
    if _smem_bytes(cfg, HP) > SMEM_LIMIT:
        return f"shared memory {_smem_bytes(cfg, HP)} B > {SMEM_LIMIT} B"
    return None


# =============================================================================
# Layout: packed weights
# =============================================================================


@dataclasses.dataclass(frozen=True)
class Layout:
    L: int
    H: int
    HP: int
    Cin: int
    O: int
    n_weights: int


def _pack(cfg, params, HP: int) -> np.ndarray:
    """The flat float32 weights the kernel reads (layout in lstm.cu): per
    layer, HP rows of [b][W_x][W_h] with each entry the (i, f, g, o) float4 of
    one unit; then head W (O, HP) and head b padded to 4."""
    H, O = cfg.hidden_size, cfg.out_channels
    parts = []
    for li, lp in enumerate(params["layers"]):
        w = _np(lp["w"]).T  # (4H, I+H), rows i, f, g, o
        b = _np(lp["b"])
        isz = cfg.in_channels if li == 0 else H
        iw = cfg.in_channels if li == 0 else HP
        rows = np.zeros((HP, 1 + iw + HP, 4), np.float32)
        for g in range(4):
            rows[:H, 0, g] = b[g * H : (g + 1) * H]
            rows[:H, 1 : 1 + isz, g] = w[g * H : (g + 1) * H, :isz]
            rows[:H, 1 + iw : 1 + iw + H, g] = w[g * H : (g + 1) * H, isz:]
        parts.append(rows.reshape(-1))
    hw = np.zeros((O, HP), np.float32)
    hw[:, :H] = _np(params["head_w"]).T
    hb = np.zeros(-(-O // 4) * 4, np.float32)
    hb[:O] = _np(params["head_b"])
    flat = np.concatenate(parts + [hw.reshape(-1), hb])
    assert flat.size == _n_weights(cfg, HP)
    return flat


def prepare(cfg, params, T: int, batch: int):
    """Packed weights and the broadcast initial state on the params' device."""
    reason = supports(cfg, T, batch)
    if reason is not None:
        raise ValueError(f"fused lstm kernel does not support this config: {reason}")
    device = params["head_b"].device
    HP = _pad_hidden(cfg.hidden_size)
    layout = Layout(L=cfg.num_layers, H=cfg.hidden_size, HP=HP, Cin=cfg.in_channels, O=cfg.out_channels,
                    n_weights=_n_weights(cfg, HP))
    eparams = {"layout": layout, "weights": torch.tensor(_pack(cfg, params, HP), device=device)}

    def bcast(key):
        return torch.stack([l[key] for l in params["layers"]])[:, :, None].expand(-1, -1, batch).contiguous()

    return eparams, {"h": bcast("h0"), "c": bcast("c0")}


# =============================================================================
# Plain version: the same step on the same layout, in torch
# =============================================================================


def unpack(layout: Layout, weights: torch.Tensor):
    """Per layer (W (4H, I+H), b (4H)) and the head (W (O, H), b (O)), read
    back out of the packed buffer."""
    H, HP = layout.H, layout.HP
    layers = []
    off = 0
    for li in range(layout.L):
        iw = layout.Cin if li == 0 else HP
        isz = layout.Cin if li == 0 else H
        n = HP * (1 + iw + HP) * 4
        rows = weights[off : off + n].view(HP, 1 + iw + HP, 4)[:H]  # (H, 1+iw+HP, gate)
        off += n
        per_gate = rows.permute(2, 0, 1)  # (gate, H, 1+iw+HP)
        w = torch.cat([per_gate[:, :, 1 : 1 + isz], per_gate[:, :, 1 + iw : 1 + iw + H]], dim=2)
        layers.append((w.reshape(4 * H, isz + H), per_gate[:, :, 0].reshape(4 * H)))
    hw = weights[off : off + layout.O * HP].view(layout.O, HP)[:, :H]
    hb = weights[off + layout.O * HP : off + layout.O * HP + layout.O]
    return layers, (hw, hb)


def step_plain(layout: Layout, weights: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """The block's recurrence in torch, h and c (L, H, B) updated in place.
    x (Cin, T', B) -> y (O, T', B)."""
    from ...models.lstm import cell_update

    layers, (hw, hb) = unpack(layout, weights)
    H = layout.H
    hs, cs = list(h.unbind(0)), list(c.unbind(0))
    tops = []
    for t in range(x.shape[1]):
        inp = x[:, t]
        for li, (w, b) in enumerate(layers):
            ifgo = torch.matmul(w, torch.cat([inp, hs[li]], dim=0)) + b[:, None]
            hs[li], cs[li] = cell_update(ifgo, cs[li], H, 0)
            inp = hs[li]
        tops.append(inp)
    Tn, B = x.shape[1], x.shape[2]
    y = torch.matmul(hw, torch.stack(tops, dim=1).reshape(H, Tn * B)).view(layout.O, Tn, B)
    h.copy_(torch.stack(hs))
    c.copy_(torch.stack(cs))
    return y + hb[:, None, None]


# =============================================================================
# The kernel: build, bind, launch
# =============================================================================


def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_lstm_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.nam_lstm_step.restype = ctypes.c_int


#: csrc/lstm.cu, built by nvcc at first launch (``LIB.build_log``: ptxas's report).
LIB = _build.Library("lstm.cu", _bind)


def launch(layout: Layout, weights: torch.Tensor, h: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: x (Cin, T', B) -> y (O, T', B);
    h and c (L, H, B) in place."""
    global launches
    for name, t in (("x", x), ("weights", weights), ("h", h), ("c", c)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[0] != layout.Cin or x.shape[1] < 1:
        raise ValueError(f"x shape {tuple(x.shape)} is not ({layout.Cin}, T >= 1, B)")
    B = x.shape[2]
    for name, t in (("h", h), ("c", c)):
        if tuple(t.shape) != (layout.L, layout.H, B):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(layout.L, layout.H, B)}")
    if weights.numel() != layout.n_weights:
        raise ValueError(f"weights hold {weights.numel()} floats, the layout {layout.n_weights}")
    lib = LIB.load()
    T = x.shape[1]
    y = torch.empty((layout.O, T, B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nam_lstm_step(
        x.data_ptr(), y.data_ptr(), h.data_ptr(), c.data_ptr(), weights.data_ptr(),
        T, B, layout.Cin, layout.H, layout.O, layout.n_weights, layout.HP, layout.L,
        int(act.using_fast_tanh), stream,
    )
    LIB.check(err, "lstm kernel")
    launches += 1
    return y


def step(cfg, T: int, eparams, state, x: torch.Tensor):
    """Block step, engine (C, T, B) convention, any block length:
    x (Cin, T', B) -> (y (O, T', B), state'). A CUDA tensor goes through the
    kernel, a CPU tensor through ``step_plain``."""
    layout: Layout = eparams["layout"]
    if x.is_cuda:
        y = launch(layout, eparams["weights"], state["h"], state["c"], x.contiguous())
    elif x.device.type == "cpu":
        y = step_plain(layout, eparams["weights"], state["h"], state["c"], x)
    else:
        raise ValueError(f"fused lstm step runs on CUDA or CPU tensors, got {x.device}")
    return y, state


# =============================================================================
# Work counts, for the bound
# =============================================================================


def work(cfg, T: int, batch: int) -> Dict[str, float]:
    """What one block needs at the least: MACs (gates and head, not the bias
    adds or the gate nonlinearities), and the bytes that must move (x and y
    once; h and c read once and written once; weights once)."""
    H, L = cfg.hidden_size, cfg.num_layers
    macs = sum(4 * H * ((cfg.input_size if li == 0 else H) + H) for li in range(L)) + cfg.out_channels * H
    n_weights = sum(4 * H * ((cfg.input_size if li == 0 else H) + H + 1) for li in range(L))
    n_weights += cfg.out_channels * (H + 1)
    per_stream = 4 * ((cfg.in_channels + cfg.out_channels) * T + 2 * 2 * L * H)
    return {
        "macs": float(macs * T * batch),
        "flops": float(2 * macs * T * batch),
        "bytes": float(per_stream * batch + 4 * n_weights),
    }
