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

What ``csrc/lstm.cu``'s registers cannot hold -- hidden sizes above 32,
more than 4 layers, more than 4 input channels -- runs on
``csrc/lstm_wide.cu`` (the wide kernels): the same step on the same state,
the weights packed input-major (``_pack_wide``); up to WIDE_MAX_HIDDEN
units, WIDE_MAX_LAYERS layers and WIDE_MAX_IN input channels. Of its two
kernels, the tile kernel (S streams a CTA, the weights in shared memory,
SPT streams a thread; ``_tile`` picks S and SPT) runs every model whose
weights and one tile fit the CTA's shared memory (``_tile_smem_bytes``),
the group kernel (a group of threads a stream, the weights read from
device memory) the rest, such as 64 x 8. Where lstm.cu and lstm_wide.cu
both run a model, ``_is_wide`` picks by its size and the batch, as a sweep
of both on an H100 showed (``tools/lstm_tiles.py --sources``, PERF.md): the
tile kernel, except where lstm.cu's thread holds h in at most 32 registers
and the batch is large enough that its one thread a stream wins (LSTM_CU_FROM:
2 x 16 at B = 65,536 in 1.57 ms against 1.80; at 32,768 0.84 against 1.22
on the tile kernel).

On a CUDA tensor ``step`` launches the kernel (or raises); on a CPU tensor it
runs ``step_plain``, the same step on the same layout in plain torch.
``launches`` counts launches of every kernel (``wide_launches`` those of
csrc/lstm_wide.cu, ``tile_launches`` those of its tile kernel) and nothing
else.
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

#: Kernel launches so far (every kernel); ``step_plain`` does not count.
launches = 0
#: Of those, launches of the wide kernels (csrc/lstm_wide.cu).
wide_launches = 0
#: Of those, launches of the tile kernel (lstm_wide.cu lstm_tile_kernel).
tile_launches = 0

MAX_IN = 4  # input channels, MAX_IN in lstm.cu
HP_TILES = (4, 8, 16, 32)  # padded hidden widths with a kernel instance
#: h of every layer lives in registers for the whole block: L * HP floats a
#: thread, at most 128 of its 255 registers (c is in shared memory). lstm.cu
#: has an instance for every (HP, L) in HP_TILES x 1..MAX_LAYERS.
MAX_LAYERS = 4
THREADS = 64  # streams per CTA, THREADS in lstm.cu
#: The batch from which lstm.cu runs a model rather than the tile kernel, by
#: its padded hidden width HP, where L * HP <= LSTM_CU_MAX_STATE; no entry:
#: never. Fitted to ``tools/lstm_tiles.py --sources`` on an H100 (PERF.md).
LSTM_CU_FROM = {4: 32768, 8: 65536, 16: 65536}
LSTM_CU_MAX_STATE = 32
# The wide kernel (csrc/lstm_wide.cu): a group of G threads per stream.
WIDE_MAX_IN = 8  # XW in lstm_wide.cu
WIDE_MAX_HIDDEN = 64
WIDE_MAX_LAYERS = 8
WIDE_THREADS = 128  # MAX_THREADS in lstm_wide.cu
# The tile kernel (lstm_wide.cu lstm_tile_kernel) and the H100 SXM it is
# sized for: 132 SMs of 228 KB of shared memory, 2,048 threads, 32 CTAs and
# 64K registers each.
TILE_SPT = (1, 2, 4)  # streams a thread: the kernel's template instances
TILE_MAX_THREADS = 512  # TILE_MAX_THREADS in lstm_wide.cu
#: Registers a thread of each instance holds (ptxas -v, rounded up to 8; chip_smoke prints them).
TILE_REGS = {1: 40, 2: 64, 4: 64}
SMS, SM_SMEM, SM_THREADS, SM_CTAS, SM_REGS = 132, 233472, 2048, 32, 65536
#: Threads the batch must give each SM at a tile's SPT (8 warps): below it,
#: the SM's sub-partitions wait on shared-memory latency (PERF.md).
TILE_SM_THREADS = 256
TILE_MIN_THREADS = 128  # threads of a tile's CTA at the least (4 warps), where H allows
#: Threads of a tile's CTA at the most where the batch takes several waves:
#: 12 warps, as many as the sweeps show an SM gains from (PERF.md).
TILE_WAVE_THREADS = 384


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
    if cfg.in_channels > WIDE_MAX_IN:
        return f"in_channels {cfg.in_channels} > {WIDE_MAX_IN}"
    if cfg.hidden_size > WIDE_MAX_HIDDEN:
        return f"hidden_size {cfg.hidden_size} > {WIDE_MAX_HIDDEN}"
    if cfg.num_layers > WIDE_MAX_LAYERS:
        return f"{cfg.num_layers} layers > {WIDE_MAX_LAYERS}"
    return None


def _lstm_cu_runs(cfg) -> bool:
    """Whether csrc/lstm.cu can run the model: it keeps h of every layer in
    registers, at most MAX_LAYERS layers of HP_TILES[-1] units, and reads at
    most MAX_IN input channels."""
    return not (cfg.in_channels > MAX_IN or cfg.hidden_size > HP_TILES[-1] or cfg.num_layers > MAX_LAYERS
                or _smem_bytes(cfg, _pad_hidden(cfg.hidden_size)) > SMEM_LIMIT)


def _is_wide(cfg, batch: int) -> bool:
    """Whether the wide kernel (csrc/lstm_wide.cu) runs the model at this
    batch: always where lstm.cu cannot; else unless h of every layer is at
    most LSTM_CU_MAX_STATE floats of lstm.cu's thread and the batch reaches
    LSTM_CU_FROM of the padded hidden width. Every model lstm.cu runs fits
    the tile kernel (``_tile`` finds a tile), so that is the kernel it
    gets. Against the faster of the two on each of 98 (model, batch) points
    of the sweep, the pick loses at most 19% (5 x 2 at 49,152), and more
    than 3% on 5 points (PERF.md)."""
    if not _lstm_cu_runs(cfg):
        return True
    HP = _pad_hidden(cfg.hidden_size)
    return cfg.num_layers * HP > LSTM_CU_MAX_STATE or batch < LSTM_CU_FROM.get(HP, 1 << 62)


def _group(H: int) -> int:
    """Threads per stream of the group kernel: 8, 16 or 32, as the hidden size needs."""
    return 8 if H <= 8 else 16 if H <= 16 else 32


def _n_wide(cfg) -> int:
    """Floats of ``_pack_wide``'s weights."""
    H = cfg.hidden_size
    rows = sum(1 + (cfg.in_channels if li == 0 else H) + H for li in range(cfg.num_layers))
    return 4 * H * rows + cfg.out_channels * (H + 1)


def _tile_smem_bytes(cfg, S: int) -> int:
    """Shared memory of a tile kernel CTA of S streams: the packed weights
    (rounded up to a float4), then h (2, L, H, S), c (L, H, S) and the input
    (2, Cin, S), as lstm_wide.cu lays them out."""
    H, L = cfg.hidden_size, cfg.num_layers
    return 4 * (-(-_n_wide(cfg) // 4) * 4 + S * (3 * L * H + 2 * cfg.in_channels))


def _tile_ctas_per_sm(cfg, S: int, spt: int) -> int:
    """CTAs of S streams, spt a thread, that one SM holds at once."""
    threads = -(-cfg.hidden_size * S // spt // 32) * 32
    return min(SM_SMEM // (_tile_smem_bytes(cfg, S) + 1024), SM_THREADS // threads, SM_CTAS,
               SM_REGS // (TILE_REGS[spt] * threads))


def _tile(cfg, batch: int) -> Optional[tuple]:
    """(S, SPT) of the tile kernel for this model and batch, or None where
    its weights and the smallest tile do not fit the CTA's shared memory.
    SPT: the largest that still gives every SM TILE_SM_THREADS threads of
    the batch's H * batch / SPT (1 if none does); more streams a thread
    read fewer weight bytes a FMA, fewer threads hide less latency. S: the
    smallest multiple of SPT whose CTA has TILE_MIN_THREADS threads and whose
    CTAs all run in one wave; where no tile within TILE_MAX_THREADS threads
    and the shared memory does, the largest of at most TILE_WAVE_THREADS
    threads. (Fitted to a sweep of every tile on an H100:
    tools/lstm_tiles.py, PERF.md.)"""
    H = cfg.hidden_size
    spt = next((p for p in TILE_SPT[::-1] if H * batch // p >= TILE_SM_THREADS * SMS), 1)
    sizes = [S for S in range(spt, spt * (TILE_MAX_THREADS // H) + 1, spt) if _tile_smem_bytes(cfg, S) <= SMEM_LIMIT]
    if not sizes:
        return None
    for S in sizes:
        if (H * S // spt >= min(TILE_MIN_THREADS, H * sizes[-1] // spt)
                and -(-batch // S) <= SMS * _tile_ctas_per_sm(cfg, S, spt)):
            return S, spt
    return max([S for S in sizes if H * S // spt <= TILE_WAVE_THREADS] or sizes[:1]), spt


# =============================================================================
# Layout: packed weights
# =============================================================================


@dataclasses.dataclass(frozen=True)
class Layout:
    L: int
    H: int
    HP: int  # padded hidden width of lstm.cu's packing; H for the wide kernel's
    Cin: int
    O: int
    n_weights: int
    wide_group: int = 0  # threads per stream of the group kernel; 0: csrc/lstm.cu runs the model
    tile: int = 0  # streams per CTA of the tile kernel (S); 0: not the tile kernel
    tile_spt: int = 0  # streams per thread of the tile kernel (SPT)


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


def _pack_wide(cfg, params) -> np.ndarray:
    """The flat float32 weights the wide kernel reads (layout in
    lstm_wide.cu): per layer, (1 + I + H) rows of H (i, f, g, o) float4s --
    the bias, then W_x, then W_h, input-major so that a group's lanes read
    consecutive float4s; then head W (O, H) and head b (O)."""
    H = cfg.hidden_size
    parts = []
    for li, lp in enumerate(params["layers"]):
        w = _np(lp["w"]).T  # (4H, I+H), rows i, f, g, o
        rows = np.concatenate([_np(lp["b"])[None], w.T])  # (1 + I + H, 4H)
        parts.append(rows.reshape(rows.shape[0], 4, H).transpose(0, 2, 1).reshape(-1))
    return np.concatenate(parts + [_np(params["head_w"]).T.reshape(-1), _np(params["head_b"])])


def prepare(cfg, params, T: int, batch: int, wide: Optional[bool] = None, tile=None):
    """Packed weights and the broadcast initial state on the params' device.
    ``wide`` picks the source and, within lstm_wide.cu, ``tile`` the kernel:
    False the group kernel, (S, SPT) that tile (for measurements and tests;
    default: ``_is_wide``, then ``_tile``)."""
    reason = supports(cfg, T, batch)
    if reason is not None:
        raise ValueError(f"fused lstm kernel does not support this config: {reason}")
    if wide is None:
        wide = _is_wide(cfg, batch)
    elif not wide and not _lstm_cu_runs(cfg):
        raise ValueError("csrc/lstm.cu cannot run this config: it needs the wide kernel")
    device = params["head_b"].device
    if wide:
        flat = _pack_wide(cfg, params)
        if tile is None:
            tile = _tile(cfg, batch) or False
        elif tile and (tile[1] not in TILE_SPT or tile[0] % tile[1]
                       or cfg.hidden_size * tile[0] // tile[1] > TILE_MAX_THREADS
                       or _tile_smem_bytes(cfg, tile[0]) > SMEM_LIMIT):
            raise ValueError(f"the tile kernel cannot run tile {tile} of this config")
        layout = Layout(L=cfg.num_layers, H=cfg.hidden_size, HP=cfg.hidden_size, Cin=cfg.in_channels,
                        O=cfg.out_channels, n_weights=flat.size, wide_group=_group(cfg.hidden_size),
                        tile=tile[0] if tile else 0, tile_spt=tile[1] if tile else 0)
    else:
        HP = _pad_hidden(cfg.hidden_size)
        flat = _pack(cfg, params, HP)
        layout = Layout(L=cfg.num_layers, H=cfg.hidden_size, HP=HP, Cin=cfg.in_channels, O=cfg.out_channels,
                        n_weights=_n_weights(cfg, HP))
    eparams = {"layout": layout, "weights": torch.tensor(flat, device=device)}

    def bcast(key):
        return torch.stack([l[key] for l in params["layers"]])[:, :, None].expand(-1, -1, batch).contiguous()

    return eparams, {"h": bcast("h0"), "c": bcast("c0")}


# =============================================================================
# Plain version: the same step on the same layout, in torch
# =============================================================================


def unpack(layout: Layout, weights: torch.Tensor):
    """Per layer (W (4H, I+H), b (4H)) and the head (W (O, H), b (O)), read
    back out of the packed buffer (either kernel's packing)."""
    H, HP = layout.H, layout.HP
    layers = []
    off = 0
    if layout.wide_group:
        for li in range(layout.L):
            rows = 1 + (layout.Cin if li == 0 else H) + H
            wb = weights[off : off + rows * H * 4].view(rows, H, 4).permute(0, 2, 1).reshape(rows, 4 * H)
            off += rows * H * 4
            layers.append((wb[1:].t(), wb[0]))
        hw = weights[off : off + layout.O * H].view(layout.O, H)
        return layers, (hw, weights[off + layout.O * H : off + layout.O * H + layout.O])
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


def _bind_wide(lib: ctypes.CDLL) -> None:
    lib.nam_lstm_wide_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.nam_lstm_wide_step.restype = ctypes.c_int
    lib.nam_lstm_tile_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.nam_lstm_tile_step.restype = ctypes.c_int


#: csrc/lstm_wide.cu, the wide kernels: its own source, so it builds beside lstm.cu.
WIDE_LIB = _build.Library("lstm_wide.cu", _bind_wide)


def launch(layout: Layout, weights: torch.Tensor, h: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel the layout names (csrc/lstm.cu, or csrc/lstm_wide.cu's
    tile or group kernel for a wide layout) on the current stream: x (Cin,
    T', B) -> y (O, T', B); h and c (L, H, B) in place."""
    global launches, wide_launches, tile_launches
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
    T = x.shape[1]
    y = torch.empty((layout.O, T, B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), y.data_ptr(), h.data_ptr(), c.data_ptr(), weights.data_ptr())
    if layout.tile:
        lib = WIDE_LIB.load()
        err = lib.nam_lstm_tile_step(*ptrs, T, B, layout.Cin, layout.H, layout.L, layout.O, layout.n_weights,
                                     layout.tile, layout.tile_spt, int(act.using_fast_tanh), stream)
        WIDE_LIB.check(err, "lstm tile kernel")
        wide_launches += 1
        tile_launches += 1
    elif layout.wide_group:
        lib = WIDE_LIB.load()
        err = lib.nam_lstm_wide_step(*ptrs, T, B, layout.Cin, layout.H, layout.L, layout.O, layout.wide_group,
                                     WIDE_THREADS, int(act.using_fast_tanh), stream)
        WIDE_LIB.check(err, "lstm group kernel")
        wide_launches += 1
    else:
        lib = LIB.load()
        err = lib.nam_lstm_step(*ptrs, T, B, layout.Cin, layout.H, layout.O, layout.n_weights, layout.HP, layout.L,
                                int(act.using_fast_tanh), stream)
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
