"""Chunked-FIFO ring state for streaming dilated convs in the (C, T, B) layout.

The port of ``neuralampmodelercore_tpu.ops.ring``, the engine tier's
constant-cost analog of the reference's ring buffers (NAM/ring_buffer.{h,cpp};
the A2 fast path's rings, NAM/wavenet/a2_fast.cpp:340-402):

  - Layout is (C, T, B): streams innermost, so neighbouring streams sit at
    neighbouring addresses; every product is ``W[O, I] @ X[I, T*B]``.
  - state = {"chunks": (M, C, T, B), "n": write slot}, M = rf // T + 2. A tap
    with lookback a reads at most two chunks; the block's input is written
    into slot n.
  - All K tap windows are stacked along C and contracted in one product.

Two differences from the JAX module: the write slot ``n`` is a host integer
(slot arithmetic needs no device round trip), and the chunk write is in
place. A state passed to ``ring_conv_step`` is therefore consumed: continue
with the returned one.

Block size T is fixed per state, as the reference pre-allocates for its
maxBufferSize at Reset (NAM/dsp.cpp:130-140).
"""

from __future__ import annotations

from typing import Dict

import torch

from .layers import Conv1dSpec, Conv1x1Spec, Params


def dot_ctb(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w: (O, I), x: (I, T, B) -> (O, T, B), one float32 product."""
    I, T, B = x.shape
    return torch.matmul(w, x.reshape(I, T * B)).reshape(w.shape[0], T, B)


def conv1x1_w_ctb(spec: Conv1x1Spec, p: Params) -> Dict:
    """Engine-layout weights for a Conv1x1 from the generic params (w (I, O))."""
    ep: Dict = {}
    if spec.depthwise:
        ep["dw"] = p["dw"].clone()  # (C,)
    else:
        ep["w"] = p["w"].t().contiguous()  # (O, I)
    if spec.bias:
        ep["b"] = p["b"].clone()
    return ep


def conv1x1_ctb(spec: Conv1x1Spec, ep: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (I, T, B) -> (O, T, B)."""
    y = x * ep["dw"][:, None, None] if spec.depthwise else dot_ctb(ep["w"], x)
    if spec.bias:
        y = y + ep["b"][:, None, None]
    return y


def conv1d_w_ctb(spec: Conv1dSpec, p: Params) -> Dict:
    """Tap-stacked engine weights from generic conv params (w (K, I, O)):
    W_all[o, k*I + i] = w[k, i, o]."""
    ep: Dict = {}
    if spec.depthwise:
        ep["dw"] = p["dw"].clone()  # (K, C)
    else:
        K, I, O = p["w"].shape
        ep["w"] = p["w"].permute(2, 0, 1).reshape(O, K * I).contiguous()
    if spec.bias:
        ep["b"] = p["b"].clone()
    return ep


def ring_num_slots(receptive_field: int, T: int) -> int:
    return receptive_field // T + 2


def ring_conv_init(spec: Conv1dSpec, T: int, batch: int, device) -> Dict:
    if spec.receptive_field == 0:
        return {}
    M = ring_num_slots(spec.receptive_field, T)
    return {"chunks": torch.zeros((M, spec.in_channels, T, batch), device=device), "n": 0}


def _chunk_rel(state: Dict, x: torch.Tensor, m_back: int) -> torch.Tensor:
    """The block m_back blocks in the past (m_back=0 -> the current x)."""
    if m_back == 0:
        return x
    chunks = state["chunks"]
    M = chunks.shape[0]
    return chunks[(state["n"] - m_back) % M]


def _tap_window(state: Dict, x: torch.Tensor, a: int, T: int) -> torch.Tensor:
    """Logical window [-a, -a+T) of the conv input stream, (C, T, B)."""
    j, o = divmod(a, T)
    if o == 0:
        return _chunk_rel(state, x, j)
    left = _chunk_rel(state, x, j + 1)[:, T - o :]
    right = _chunk_rel(state, x, j)[:, : T - o]
    return torch.cat([left, right], dim=1)


def ring_conv_step(spec: Conv1dSpec, T: int, ep: Params, state: Dict, x: torch.Tensor):
    """Streaming dilated conv over one T-frame block in (C, T, B) layout, the
    RingBuffer Read(n, lookback) contract (NAM/conv1d.cpp:244-252) at O(T)
    traffic. Writes x into the ring in place; returns (y, state')."""
    K, d, rf = spec.kernel_size, spec.dilation, spec.receptive_field
    if x.shape[1] != T:
        raise ValueError(f"ring engine requires fixed block size {T}, got {x.shape[1]}")
    windows = [_tap_window(state, x, (K - 1 - k) * d, T) for k in range(K)]
    if spec.depthwise:
        y = None
        for k, win in enumerate(windows):
            contrib = win * ep["dw"][k][:, None, None]
            y = contrib if y is None else y + contrib
    else:
        stacked = torch.cat(windows, dim=0) if K > 1 else windows[0]
        y = dot_ctb(ep["w"], stacked)
    if spec.bias:
        y = y + ep["b"][:, None, None]
    if rf == 0:
        return y, state
    chunks, n = state["chunks"], state["n"]
    # In place: slot n is never one of the slots read above (m_back <= M - 1).
    chunks[n].copy_(x)
    return y, {"chunks": chunks, "n": (n + 1) % chunks.shape[0]}
