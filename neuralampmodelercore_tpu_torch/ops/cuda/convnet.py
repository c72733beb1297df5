"""Fused ConvNet block step: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_make_kernel`` of ``neuralampmodelercore_tpu/ops/
pallas/convnet.py`` (its ``step`` reaches ``pl.pallas_call`` at
convnet.py:458), K3 in ROADMAP.md: every conv block and the head of one
block in one launch, with the state updated in place. The kernel is
``csrc/convnet.cu``; its header says what bounds it on an H100 and how the
design answers that.

Engine-facing API (mirrors ``models.convnet.engine_prepare/engine_step``):

    reason = supports(cfg, T, batch)       # None, or why the kernel refuses
    eparams, state = prepare(cfg, params, T, batch)
    y, state = step(cfg, T, eparams, state, x)   # x (Cin, T, B) -> y (Cout, T, B)

State is one flat float32 buffer holding a ring of M = rf // T + 2 whole
blocks, (M, cin, T, B), per layer, plus the block counter ``n``: a host
integer that wraps at the LCM of the ring sizes. A dilation need not be a
multiple of T: each tap's slot and frame are computed per element. ``step``
writes the rings in place: the state passed in is consumed.

What ``csrc/convnet.cu``'s register tile cannot hold -- more than 32
channels, blocks of more than 512 frames, PReLU with a slope per channel --
runs on ``csrc/convnet_wide.cu`` (the wide kernel): the same step on the
same plan, weights padded to WIDE_RW-row slices, and the same state, with
the layer input and output of every frame in shared memory; up to
WIDE_MAX_CHANNELS channels and WIDE_MAX_T frames. ``supports`` picks it
only when the register-tile kernel refuses the model.

On a CUDA tensor ``step`` launches the kernel (or raises); on a CPU tensor it
runs ``step_plain``, the same step on the same state layout in plain torch.
``launches`` counts launches of both kernels (``wide_launches`` those of the
wide kernel) and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import activations as act
from . import _build
from .stack import (MAX_T, SMEM_LIMIT, WIDE_MAX_T, WIDE_RW, WIDE_THREADS, _act_code_prm, _act_plain, _dense_conv,
                    _np, _pad4, _streams_per_cta, wide_fit)

#: Kernel launches so far (both kernels); ``step_plain`` does not count.
launches = 0
#: Of those, launches of the wide kernel (csrc/convnet_wide.cu).
wide_launches = 0

MAX_CHANNELS = 32
WIDE_MAX_CHANNELS = 128

# Plan layout, as the constants in convnet.cu.
P_HEADER, LF = 10, 8


# =============================================================================
# Gate
# =============================================================================


def supports(cfg, T: int, batch: int) -> Optional[str]:
    """None if the kernel runs this (config, block size, batch), else why not.
    Any batch (the ragged tile is masked), any dilation, and the activation
    under the fast-tanh and LUT modes (baked in at ``prepare``)."""
    from ...models.convnet import ConvNetConfig

    if not isinstance(cfg, ConvNetConfig):
        return f"not a ConvNetConfig: {type(cfg).__name__}"
    if batch < 1:
        return f"batch {batch} < 1"
    if not 1 <= T <= WIDE_MAX_T:
        return f"block size T={T} outside 1..{WIDE_MAX_T}"
    if not cfg.dilations:
        return "no conv blocks"
    if max(cfg.in_channels, cfg.channels, cfg.out_channels) > WIDE_MAX_CHANNELS:
        return f"more than {WIDE_MAX_CHANNELS} channels"
    a = cfg.activation
    if a.type not in act.KERNEL_CODES:
        return f"activation {a.type} not in the kernel"
    if a.type == "PReLU" and cfg.channels % len(act.prelu_slopes(a)):
        return f"PReLU with {len(act.prelu_slopes(a))} slopes on {cfg.channels} channels"
    if _is_wide(cfg, T) and not _wide_launch(cfg, T)[0]:
        return f"shared memory {_wide_smem_bytes(cfg, T, 1)} B > {SMEM_LIMIT} B at T={T} (wide kernel)"
    return None


def _is_wide(cfg, T: int) -> bool:
    """Whether the model needs the wide kernel (csrc/convnet_wide.cu): the
    register-tile kernel (csrc/convnet.cu) runs at most MAX_T frames and
    MAX_CHANNELS channels in its shared memory, and one PReLU slope."""
    a = cfg.activation
    return (T > MAX_T or max(cfg.in_channels, cfg.channels, cfg.out_channels) > MAX_CHANNELS
            or (a.type == "PReLU" and len(act.prelu_slopes(a)) > 1) or _smem_bytes(cfg, T) > SMEM_LIMIT)


def _c_max(cfg, wide: bool = False) -> int:
    """Padded rows of the packed weights: 4, 8, 16 or 32 for the register
    tile, a multiple of WIDE_RW for the wide kernel."""
    rows = max(cfg.in_channels, cfg.channels)
    return -(-rows // WIDE_RW) * WIDE_RW if wide else _pad4(rows)


def _wide_seg_max(cfg) -> int:
    """Floats of the largest layer segment in the wide kernel's layout."""
    from ...models.convnet import block_spec

    CP = _c_max(cfg, wide=True)
    return max(_seg_len(2, block_spec(cfg, i).in_channels, CP) for i in range(len(cfg.dilations)))


def _wide_smem_bytes(cfg, T: int, BS: int, staged: bool = False) -> int:
    """The wide kernel's two (rows, T, BS) buffers, the layer input and
    output, and with ``staged`` a layer's weight segment."""
    return 4 * (2 * _c_max(cfg, wide=True) * T * BS + (_wide_seg_max(cfg) if staged else 0))


def _wide_launch(cfg, T: int) -> Tuple[int, bool]:
    """(streams per CTA, weights staged in shared memory) of the wide kernel
    (``stack.wide_fit``)."""
    return wide_fit(T, _c_max(cfg, wide=True), lambda BS, staged: _wide_smem_bytes(cfg, T, BS, staged))


def _seg_len(K: int, cin: int, CP: int) -> int:
    return K * cin * CP + 2 * CP


def _smem_bytes(cfg, T: int) -> int:
    """The register-tile kernel's (at most MAX_CHANNELS channels): two weight
    segments and the double-buffered (CP, T, streams) layer input."""
    from ...models.convnet import block_spec

    CP = _c_max(cfg)
    seg_max = max(_seg_len(2, block_spec(cfg, i).in_channels, CP) for i in range(len(cfg.dilations)))
    return 4 * (2 * seg_max + 2 * CP * T * _streams_per_cta(T))


# =============================================================================
# Layout: packed weights, plan and state offsets
# =============================================================================


@dataclasses.dataclass(frozen=True)
class LayerLayout:
    K: int
    d: int
    cin: int
    M: int  # ring slots
    ring: int  # float offset of the (M, cin, T, B) ring in the state buffer
    seg: int  # float offset of the weight segment
    seg_len: int


@dataclasses.dataclass(frozen=True)
class Layout:
    T: int
    B: int
    BS: int
    Cin: int
    C: int
    Cout: int
    c_max: int  # padded rows of the weights: the register tile (4/8/16/32), or a multiple of WIDE_RW
    head_w: int  # (Cout, C)
    head_b: int
    act_code: int  # as activations.kernel_code resolves the activation under ``modes``
    act_prm: int
    seg_max: int
    state_size: int
    wrap: int
    smem_bytes: int
    modes: Tuple  # activations.modes() at prepare
    layers: Tuple[LayerLayout, ...]
    wide_threads: int = 0  # threads of the wide kernel; 0: csrc/convnet.cu runs the model
    wide_seg_max: int = 0  # floats of the wide kernel's staged weight segment; 0: read from device memory


def _build_layout(cfg, params, T: int, batch: int) -> Tuple[Layout, np.ndarray]:
    """Pack every weight into one flat float32 array (each segment 16-byte
    aligned) and assign ring offsets in the flat state buffer. Grouped and
    depthwise convs are densified here."""
    from ...models.convnet import block_spec

    chunks: List[np.ndarray] = []
    size = 0

    def put(a: np.ndarray) -> int:
        nonlocal size
        a = np.ascontiguousarray(a, dtype=np.float32).reshape(-1)
        pad = -(-a.size // 4) * 4 - a.size
        off = size
        chunks.append(np.concatenate([a, np.zeros(pad, np.float32)]) if pad else a)
        size += a.size + pad
        return off

    wide = _is_wide(cfg, T)
    CP = _c_max(cfg, wide)
    C = cfg.channels
    layers: List[LayerLayout] = []
    state_size, wrap = 0, 1
    for i, bp in enumerate(params["blocks"]):
        spec = block_spec(cfg, i)
        K, d, cin = spec.kernel_size, spec.dilation, spec.in_channels
        w = _dense_conv(bp["conv"])  # (K, cin, C)
        conv = np.zeros((K * cin, CP), np.float32)
        conv[:, :C] = w.reshape(K * cin, C)
        mul, add = np.zeros(CP, np.float32), np.zeros(CP, np.float32)
        if cfg.batchnorm:
            mul[:C], add[:C] = _np(bp["bn_scale"]), _np(bp["bn_loc"])
        else:
            mul[:C], add[:C] = 1.0, _np(bp["conv"]["b"])
        seg = put(np.concatenate([conv.reshape(-1), mul, add]))
        rf = (K - 1) * d
        M = rf // T + 2 if rf > 0 else 0
        layers.append(LayerLayout(K=K, d=d, cin=cin, M=M, ring=state_size, seg=seg, seg_len=_seg_len(K, cin, CP)))
        state_size += M * cin * T * batch
        if M:
            wrap = wrap * M // math.gcd(wrap, M)
    head_w = put(_np(params["head_w"]).T)  # (Cout, C)
    head_b = put(_np(params["head_b"]))
    code, prm = _act_code_prm(cfg.activation, C, max(CP, act.KERNEL_PARAMS))
    BS, staged = _wide_launch(cfg, T) if wide else (_streams_per_cta(T), False)
    seg_max = max(lp.seg_len for lp in layers)
    layout = Layout(
        T=T, B=batch, BS=BS, Cin=cfg.in_channels, C=C, Cout=cfg.out_channels, c_max=CP,
        head_w=head_w, head_b=head_b, act_code=code, act_prm=put(prm), seg_max=seg_max,
        state_size=state_size, wrap=wrap,
        smem_bytes=_wide_smem_bytes(cfg, T, BS, staged) if wide else _smem_bytes(cfg, T),
        modes=act.modes(), layers=tuple(layers),
        wide_threads=min(WIDE_THREADS, -(-T * BS * (CP // WIDE_RW) // 32) * 32) if wide else 0,
        wide_seg_max=seg_max if staged else 0,
    )
    return layout, np.concatenate(chunks)


def _pack_plan(layout: Layout) -> np.ndarray:
    """The int64 plan the kernel reads (field order as in convnet.cu)."""
    plan = np.zeros(P_HEADER + LF * len(layout.layers), np.int64)
    plan[:9] = [len(layout.layers), layout.Cin, layout.Cout, layout.C, layout.head_w, layout.head_b,
                layout.seg_max, layout.act_code, layout.act_prm]
    for i, lp in enumerate(layout.layers):
        base = P_HEADER + LF * i
        plan[base : base + 7] = [lp.K, lp.d, lp.M, lp.ring, lp.seg, lp.seg_len, lp.cin]
    return plan


def prepare(cfg, params, T: int, batch: int):
    """Packed weights, plan and zero state on the params' device."""
    reason = supports(cfg, T, batch)
    if reason is not None:
        raise ValueError(f"fused convnet kernel does not support this config: {reason}")
    device = params["head_b"].device
    layout, flat = _build_layout(cfg, params, T, batch)
    eparams = {
        "layout": layout,
        "weights": torch.tensor(flat, device=device),
        "plan": torch.tensor(_pack_plan(layout), device=device),
    }
    return eparams, {"buf": torch.zeros(max(layout.state_size, 1), device=device), "n": 0}


def rings(layout: Layout, buf: torch.Tensor) -> List[torch.Tensor]:
    """(M, cin, T, B) views of each layer's ring in the state buffer."""
    return [
        buf[lp.ring : lp.ring + lp.M * lp.cin * layout.T * layout.B].view(lp.M, lp.cin, layout.T, layout.B)
        for lp in layout.layers
    ]


# =============================================================================
# Plain version: the same step on the same state layout, in torch
# =============================================================================


def step_plain(layout: Layout, weights: torch.Tensor, buf: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """One block through every layer, reading the weights back out of the
    packed buffer and writing the rings in place. x (Cin, T, B) -> (Cout, T, B)."""
    T, B, C, CP = layout.T, layout.B, layout.C, layout.c_max
    prm = weights[layout.act_prm : layout.act_prm + max(CP, act.KERNEL_PARAMS)]
    h = x
    for lp, ring in zip(layout.layers, rings(layout, buf)):
        K, d, cin = lp.K, lp.d, lp.cin
        conv_w = weights[lp.seg : lp.seg + K * cin * CP].view(K * cin, CP)[:, :C].t()  # (C, K*cin)
        off = lp.seg + K * cin * CP
        mul, add = weights[off : off + C], weights[off + CP : off + CP + C]
        # Logical history [-mmax*T, T): mmax past blocks, then this one.
        mmax = -(-(K - 1) * d // T)
        hist = torch.cat([ring[(n - m) % lp.M] for m in range(mmax, 0, -1)] + [h], dim=1)
        wins = [hist[:, mmax * T - (K - 1 - k) * d :][:, :T] for k in range(K)]
        z = torch.matmul(conv_w, torch.cat(wins, dim=0).reshape(K * cin, T * B)).view(C, T, B)
        z = z * mul[:, None, None] + add[:, None, None]
        ring[n % lp.M].copy_(h)
        h = _act_plain(layout.act_code, prm, z)
    head_w = weights[layout.head_w : layout.head_w + layout.Cout * C].view(layout.Cout, C)
    head_b = weights[layout.head_b : layout.head_b + layout.Cout]
    return torch.matmul(head_w, h.reshape(C, T * B)).view(layout.Cout, T, B) + head_b[:, None, None]


# =============================================================================
# The kernel: build, bind, launch
# =============================================================================


def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_convnet_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nam_convnet_step.restype = ctypes.c_int


def _bind_wide(lib: ctypes.CDLL) -> None:
    lib.nam_convnet_wide_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.nam_convnet_wide_step.restype = ctypes.c_int


#: csrc/convnet.cu, built by nvcc at first launch (``LIB.build_log``: ptxas's report).
LIB = _build.Library("convnet.cu", _bind)
#: csrc/convnet_wide.cu, the wide kernel: its own source, so it builds beside convnet.cu.
WIDE_LIB = _build.Library("convnet_wide.cu", _bind_wide)


def launch(layout: Layout, weights: torch.Tensor, plan: torch.Tensor, buf: torch.Tensor,
           x: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the kernel the layout names (csrc/convnet.cu, or csrc/convnet_wide.cu
    for a wide layout) on the current stream: x (Cin, T, B) -> y (Cout, T, B)."""
    global launches, wide_launches
    T, B = layout.T, layout.B
    for name, t in (("x", x), ("weights", weights), ("state", buf)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if plan.device != x.device or plan.dtype != torch.int64:
        raise ValueError("plan must be an int64 tensor on x's device")
    if tuple(x.shape) != (layout.Cin, T, B):
        raise ValueError(f"x shape {tuple(x.shape)} != {(layout.Cin, T, B)}")
    y = torch.empty((layout.Cout, T, B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), y.data_ptr(), buf.data_ptr(), weights.data_ptr(), plan.data_ptr(), T, B, n, layout.BS)
    if layout.wide_threads:
        lib = WIDE_LIB.load()
        err = lib.nam_convnet_wide_step(*args, layout.c_max, layout.c_max, layout.wide_seg_max, layout.wide_threads,
                                        layout.smem_bytes, stream)
        WIDE_LIB.check(err, "convnet wide kernel")
        wide_launches += 1
    else:
        lib = LIB.load()
        LIB.check(lib.nam_convnet_step(*args, layout.c_max, layout.smem_bytes, stream), "convnet kernel")
    launches += 1
    return y


def step(cfg, T: int, eparams, state, x: torch.Tensor):
    """Block step, engine (C, T, B) convention: x (Cin, T, B) -> (y (Cout, T, B), state').
    A CUDA tensor goes through the kernel, a CPU tensor through ``step_plain``."""
    layout: Layout = eparams["layout"]
    if act.modes() != layout.modes:
        raise ValueError("fast-tanh / LUT modes changed since the fused engine was built: "
                         f"built under {layout.modes}, now {act.modes()}")
    n = state["n"] % layout.wrap
    if x.is_cuda:
        y = launch(layout, eparams["weights"], eparams["plan"], state["buf"], x.contiguous(), n)
    elif x.device.type == "cpu":
        y = step_plain(layout, eparams["weights"], state["buf"], x, n)
    else:
        raise ValueError(f"fused convnet step runs on CUDA or CPU tensors, got {x.device}")
    return y, {"buf": state["buf"], "n": (n + 1) % layout.wrap}


# =============================================================================
# Work counts, for the bound
# =============================================================================


def work(cfg, T: int, batch: int) -> Dict[str, float]:
    """What one block needs at the least: MACs (convs and head, not the bias
    or affine adds), and the bytes that must move (input and output once; per
    layer, the distinct past frames its taps read and the min(rf, T) frames of
    new history, for cin channels; weights once)."""
    from ...models.convnet import block_spec

    C, O = cfg.channels, cfg.out_channels
    macs = C * O
    state_cols = 0
    n_weights = C * O + O
    for i in range(len(cfg.dilations)):
        spec = block_spec(cfg, i)
        K, d, cin = spec.kernel_size, spec.dilation, spec.in_channels
        macs += K * (cin // cfg.groups) * C  # a grouped conv's dense weight is block-diagonal
        n_weights += K * (cin // cfg.groups) * C + 2 * C
        rf = (K - 1) * d
        past = len({t - (K - 1 - k) * d for k in range(K) for t in range(T)} & set(range(-rf, 0)))
        state_cols += cin * (past + min(rf, T))
    per_stream = 4 * (state_cols + (cfg.in_channels + O) * T)
    return {
        "macs": float(macs * T * batch),
        "flops": float(2 * macs * T * batch),
        "bytes": float(per_stream * batch + 4 * n_weights),
    }
