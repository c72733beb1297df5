"""Fused WaveNet stack step: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_make_kernel`` of ``neuralampmodelercore_tpu/ops/
pallas/stack.py`` (its ``step`` reaches ``pl.pallas_call`` at stack.py:1769)
on its plain path, K1a in ROADMAP.md: every layer array and layer of one
block in one launch, with the state updated in place. The kernel is
``csrc/stack.cu``; its header says what bounds it on an H100 and how the
design answers that.

Engine-facing API (mirrors ``models.wavenet.engine_prepare/engine_step``):

    reason = supports(cfg, T, batch)       # None, or why the kernel refuses
    eparams, state = prepare(cfg, params, T, batch)
    y, state = step(cfg, T, eparams, state, x)   # x (Cin, T, B) -> y (Cout, T, B)

State is one flat float32 buffer holding a ring of M = rf // T + 2 whole
blocks, (M, C, T, B), for every layer with a receptive field, plus the block
counter ``n``: a host integer that wraps at the LCM of the ring sizes, so slot
indices need no device round trip. ``step`` writes the rings in place: the
state passed in is consumed.

On a CUDA tensor ``step`` launches the kernel (or raises); on a CPU tensor it
runs ``step_plain``, the same step on the same state layout in plain torch.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import activations as act
from . import _build

#: Kernel launches so far; ``step_plain`` does not count.
launches = 0

MAX_T = 512  # one thread per (frame, stream); at most 512 threads per CTA
MAX_CHANNELS = 32
MAX_IN_CHANNELS = 4  # SMAX in stack.cu
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper

# Activation codes, as the enum in stack.cu.
ACT_CODES = {
    "Identity": 0, "Tanh": 1, "ReLU": 2, "Sigmoid": 3, "Hardtanh": 4,
    "LeakyReLU": 5, "PReLU": 5, "SiLU": 6, "Softsign": 7, "Hardswish": 8,
    "Fasttanh": 9, "LeakyHardtanh": 10,
}

# Plan layout, as the constants in stack.cu.
P_HEADER, AF, LF = 8, 10, 10


# =============================================================================
# Gate
# =============================================================================


def supports(cfg, T: int, batch: int) -> Optional[str]:
    """None if the kernel runs this (config, block size, batch), else why not.
    Everything beyond K1a names the ROADMAP item that brings it."""
    from ...models.wavenet import NONE, WaveNetConfig

    if not isinstance(cfg, WaveNetConfig):
        return f"not a WaveNetConfig: {type(cfg).__name__}"
    if batch < 1:
        return f"batch {batch} < 1"
    if not 1 <= T <= MAX_T:
        return f"block size T={T} outside 1..{MAX_T} (one thread per frame and stream)"
    if cfg.condition_config is not None:
        return "condition DSP (ROADMAP K1e)"
    if cfg.head is not None:
        return "post-stack head (ROADMAP K1d)"
    if act.using_fast_tanh:
        return "fast-tanh mode is on (ROADMAP K1f)"
    if act.lut_active():
        return "LUT activation mode is on (ROADMAP K1f)"
    if cfg.in_channels > MAX_IN_CHANNELS:
        return f"in_channels {cfg.in_channels} > {MAX_IN_CHANNELS}"
    for ai, ac in enumerate(cfg.layer_arrays):
        where = f"array {ai}"
        if any(g != NONE for g in ac.gating_modes):
            return f"{where}: gated or blended layers (ROADMAP K1b)"
        if ac.bottleneck != ac.channels:
            return f"{where}: bottleneck != channels (ROADMAP K1b)"
        if ac.head1x1_active:
            return f"{where}: head1x1 (ROADMAP K1b)"
        if any(site.active for _, site in ac.films):
            return f"{where}: FiLM (ROADMAP K1c)"
        if ac.head_kernel_size != 1:
            return f"{where}: head rechannel kernel_size {ac.head_kernel_size} > 1 (ROADMAP K1d)"
        if ac.condition_size != cfg.in_channels:
            return f"{where}: condition_size {ac.condition_size} != in_channels {cfg.in_channels}"
        if ac.channels > MAX_CHANNELS or ac.head_size > MAX_CHANNELS:
            return f"{where}: more than {MAX_CHANNELS} channels"
        for li, a in enumerate(ac.activations):
            if a.type not in ACT_CODES:
                return f"{where} layer {li}: activation {a.type} not in the kernel"
            if a.type == "PReLU" and len(act.prelu_slopes(a)) > 1:
                return f"{where} layer {li}: per-channel PReLU not in the kernel"
    if _smem_bytes(cfg, T) > SMEM_LIMIT:
        return f"shared memory {_smem_bytes(cfg, T)} B > {SMEM_LIMIT} B at T={T}"
    return None


def _pad4(c: int) -> int:
    """Register-tile width for c channels: 4, 8, 16 or 32."""
    for p in (4, 8, 16, 32):
        if c <= p:
            return p
    raise ValueError(f"{c} channels > {MAX_CHANNELS}")


def _streams_per_cta(T: int) -> int:
    return max(1, min(32, 512 // T))


def _seg_len(K: int, C: int, S: int, l1: bool) -> int:
    CP = _pad4(C)
    n = K * C * CP + CP + S * CP + (CP * CP + CP if l1 else 0) + 4
    return -(-n // 4) * 4


def _smem_bytes(cfg, T: int) -> int:
    seg_max = max(
        _seg_len(k, ac.channels, ac.condition_size, ac.layer1x1_active)
        for ac in cfg.layer_arrays
        for k in ac.kernel_sizes
    )
    c_max = max(ac.channels for ac in cfg.layer_arrays)
    return 4 * (2 * seg_max + 2 * c_max * T * _streams_per_cta(T))


# =============================================================================
# Layout: packed weights, plan and state offsets
# =============================================================================


@dataclasses.dataclass(frozen=True)
class LayerLayout:
    K: int
    d: int
    M: int  # ring slots; 0 => no ring (rf == 0)
    ring: int  # float offset of the (M, C, T, B) ring in the state buffer
    seg: int  # float offset of the weight segment
    seg_len: int
    activation: Any  # ActivationConfig
    l1: bool


@dataclasses.dataclass(frozen=True)
class ArrayLayout:
    C: int
    CP: int
    I: int
    HS: int
    rech: int  # (C, I)
    hr: int  # (HS, C)
    hr_b: int  # (HS,) or -1
    first: int
    layers: Tuple[LayerLayout, ...]


@dataclasses.dataclass(frozen=True)
class Layout:
    T: int
    B: int
    BS: int
    Cin: int
    Cout: int
    c_max: int  # register tile of the kernel instance (4/8/16/32)
    head_scale: int
    seg_max: int
    state_size: int
    wrap: int
    smem_bytes: int
    arrays: Tuple[ArrayLayout, ...]

    @property
    def layers(self) -> Tuple[LayerLayout, ...]:
        return tuple(lp for ap in self.arrays for lp in ap.layers)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _dense_1x1(p: Dict) -> np.ndarray:
    """Dense (in, out) weight of conv1x1 params (depthwise -> diagonal)."""
    return np.diag(_np(p["dw"])) if "dw" in p else _np(p["w"])


def _dense_conv(p: Dict) -> np.ndarray:
    """Dense (K, in, out) weight of conv1d params (depthwise -> per-tap diagonal)."""
    if "dw" not in p:
        return _np(p["w"])
    dw = _np(p["dw"])  # (K, C)
    return np.stack([np.diag(dw[k]) for k in range(dw.shape[0])])


def _act_params(a) -> List[float]:
    if a.type == "LeakyReLU":
        return [a.negative_slope if a.negative_slope is not None else 0.01, 0.0, 0.0, 0.0]
    if a.type == "PReLU":
        return [act.prelu_slopes(a)[0], 0.0, 0.0, 0.0]
    if a.type == "LeakyHardtanh":
        return [
            a.min_val if a.min_val is not None else -1.0,
            a.max_val if a.max_val is not None else 1.0,
            a.min_slope if a.min_slope is not None else 0.01,
            a.max_slope if a.max_slope is not None else 0.01,
        ]
    return [0.0, 0.0, 0.0, 0.0]


def _build_layout(cfg, params, T: int, batch: int) -> Tuple[Layout, np.ndarray]:
    """Pack every weight into one flat float32 array (each segment 16-byte
    aligned) and assign ring offsets in the flat state buffer."""
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

    S = cfg.in_channels
    state_size = 0
    wrap = 1
    arrays: List[ArrayLayout] = []
    n_layers = 0
    for ai, ac in enumerate(cfg.layer_arrays):
        ap = params["arrays"][ai]
        C, CP = ac.channels, _pad4(ac.channels)
        rech = put(_dense_1x1(ap["rechannel"]).T)  # (C, I)
        layers: List[LayerLayout] = []
        for li in range(ac.num_layers):
            lp = ap["layers"][li]
            K, d = ac.kernel_sizes[li], ac.dilations[li]
            w = _dense_conv(lp["conv"])  # (K, C, C) = (k, in c, out o)
            seg = [np.zeros((K * C, CP), np.float32), np.zeros(CP, np.float32), np.zeros((S, CP), np.float32)]
            seg[0][:, :C] = w.reshape(K * C, C)
            seg[1][:C] = _np(lp["conv"]["b"])
            seg[2][:, :C] = _dense_1x1(lp["mixin"])  # (S, C)
            if ac.layer1x1_active:
                l1 = np.zeros((CP, CP), np.float32)
                l1[:C, :C] = _dense_1x1(lp["layer1x1"])  # (in o, out c)
                l1b = np.zeros(CP, np.float32)
                l1b[:C] = _np(lp["layer1x1"]["b"])
                seg += [l1, l1b]
            seg.append(np.asarray(_act_params(ac.activations[li]), np.float32))
            flat = np.concatenate([s.reshape(-1) for s in seg])
            seg_off = put(flat)
            rf = (K - 1) * d
            M = rf // T + 2 if rf > 0 else 0
            ring = state_size
            state_size += M * C * T * batch
            if M:
                wrap = wrap * M // math.gcd(wrap, M)
            layers.append(
                LayerLayout(
                    K=K, d=d, M=M, ring=ring, seg=seg_off,
                    seg_len=_seg_len(K, C, S, ac.layer1x1_active),
                    activation=ac.activations[li], l1=ac.layer1x1_active,
                )
            )
        hr_p = ap["head_rechannel"]
        hr = put(_dense_conv(hr_p)[0].T)  # (HS, C)
        hr_b = put(_np(hr_p["b"])) if "b" in hr_p else -1
        arrays.append(
            ArrayLayout(
                C=C, CP=CP, I=ac.input_size, HS=ac.head_size, rech=rech, hr=hr, hr_b=hr_b,
                first=n_layers, layers=tuple(layers),
            )
        )
        n_layers += len(layers)
    head_scale = put(np.asarray([float(_np(params["head_scale"]))], np.float32))
    c_max = _pad4(max([a.CP for a in arrays] + [a.HS for a in arrays] + [cfg.in_channels]))
    layout = Layout(
        T=T, B=batch, BS=_streams_per_cta(T), Cin=cfg.in_channels, Cout=cfg.out_channels_,
        c_max=c_max, head_scale=head_scale,
        seg_max=max((lp.seg_len for a in arrays for lp in a.layers), default=4),
        state_size=state_size, wrap=wrap, smem_bytes=_smem_bytes(cfg, T),
        arrays=tuple(arrays),
    )
    return layout, np.concatenate(chunks)


def _pack_plan(layout: Layout) -> np.ndarray:
    """The int64 plan the kernel reads (field order as in stack.cu)."""
    n_layers = len(layout.layers)
    plan = np.zeros(P_HEADER + AF * len(layout.arrays) + LF * n_layers, np.int64)
    plan[:7] = [len(layout.arrays), layout.Cin, layout.Cout, layout.head_scale,
                layout.seg_max, n_layers, layout.c_max]
    for ai, a in enumerate(layout.arrays):
        base = P_HEADER + AF * ai
        plan[base : base + 9] = [a.C, a.CP, a.I, a.HS, a.rech, a.hr, a.hr_b, a.first, len(a.layers)]
    base = P_HEADER + AF * len(layout.arrays)
    for g, lp in enumerate(layout.layers):
        plan[base + LF * g : base + LF * g + 8] = [
            lp.K, lp.d, lp.M, lp.ring, lp.seg, lp.seg_len, ACT_CODES[lp.activation.type], int(lp.l1)
        ]
    return plan


def prepare(cfg, params, T: int, batch: int):
    """Packed weights, plan and zero state on the params' device."""
    reason = supports(cfg, T, batch)
    if reason is not None:
        raise ValueError(f"fused stack kernel does not support this config: {reason}")
    device = params["head_scale"].device
    layout, flat = _build_layout(cfg, params, T, batch)
    eparams = {
        "layout": layout,
        "weights": torch.tensor(flat, device=device),
        "plan": torch.tensor(_pack_plan(layout), device=device),
    }
    state = {"buf": torch.zeros(max(layout.state_size, 1), device=device), "n": 0}
    return eparams, state


def rings(layout: Layout, buf: torch.Tensor) -> List[Optional[torch.Tensor]]:
    """(M, C, T, B) views of each layer's ring in the state buffer (None
    where a layer has no ring)."""
    out = []
    for a in layout.arrays:
        for lp in a.layers:
            n = lp.M * a.C * layout.T * layout.B
            out.append(buf[lp.ring : lp.ring + n].view(lp.M, a.C, layout.T, layout.B) if lp.M else None)
    return out


# =============================================================================
# Plain version: the same step on the same state layout, in torch
# =============================================================================


def step_plain(layout: Layout, weights: torch.Tensor, buf: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """One block through every array, reading the weights back out of the
    packed buffer and writing the rings in place. x (Cin, T, B) -> (Cout, T, B)."""
    T, B, S = layout.T, layout.B, layout.Cin

    def mat(off: int, rows: int, cols: int) -> torch.Tensor:
        return weights[off : off + rows * cols].view(rows, cols)

    ring_views = iter(rings(layout, buf))
    layer_out = x
    head = None
    for a in layout.arrays:
        C, CP = a.C, a.CP
        h = torch.matmul(mat(a.rech, C, a.I), layer_out.reshape(a.I, T * B)).view(C, T, B)
        hacc = torch.zeros(C, T, B, device=x.device) if head is None else head
        for lp in a.layers:
            ring = next(ring_views)
            K, d = lp.K, lp.d
            conv_w = mat(lp.seg, K * C, CP)[:, :C].t()  # (C out, K*C)
            off = lp.seg + K * C * CP
            bias = weights[off : off + C]
            mix = mat(off + CP, S, CP)[:, :C].t()  # (C, S)
            # Logical history [-mmax*T, T): mmax past blocks, then this one.
            mmax = -(-(K - 1) * d // T)
            past = [ring[(n - m) % lp.M] for m in range(mmax, 0, -1)] if lp.M else []
            hist = torch.cat(past + [h], dim=1)
            wins = [hist[:, mmax * T - (K - 1 - k) * d :][:, :T] for k in range(K)]
            z = torch.matmul(conv_w, torch.cat(wins, dim=0).reshape(K * C, T * B)).view(C, T, B)
            z = (z + bias[:, None, None]) + torch.matmul(mix, x.reshape(S, T * B)).view(C, T, B)
            av = act.apply(lp.activation, z, channel_axis=0)
            if lp.M:
                ring[n % lp.M].copy_(h)
            hacc = hacc + av
            if lp.l1:
                l1_off = off + CP + S * CP
                l1_w = mat(l1_off, CP, CP)[:C, :C].t()  # (out c, in o)
                l1_b = weights[l1_off + CP * CP : l1_off + CP * CP + C]
                h = h + (torch.matmul(l1_w, av.reshape(C, T * B)).view(C, T, B) + l1_b[:, None, None])
        layer_out = h
        head = torch.matmul(mat(a.hr, a.HS, C), hacc.reshape(C, T * B)).view(a.HS, T, B)
        if a.hr_b >= 0:
            head = head + weights[a.hr_b : a.hr_b + a.HS][:, None, None]
    return weights[layout.head_scale] * head


# =============================================================================
# The kernel: build, bind, launch
# =============================================================================

def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_stack_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nam_stack_step.restype = ctypes.c_int


#: csrc/stack.cu, built by nvcc at first launch (``LIB.build_log``: ptxas's report).
LIB = _build.Library("stack.cu", _bind)


def launch(layout: Layout, weights: torch.Tensor, plan: torch.Tensor, buf: torch.Tensor,
           x: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the kernel on the current stream: x (Cin, T, B) -> y (Cout, T, B)."""
    global launches
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
    lib = LIB.load()
    y = torch.empty((layout.Cout, T, B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nam_stack_step(
        x.data_ptr(), y.data_ptr(), buf.data_ptr(), weights.data_ptr(), plan.data_ptr(),
        T, B, n, layout.BS, layout.c_max, layout.smem_bytes, stream,
    )
    LIB.check(err, "stack kernel")
    launches += 1
    return y


def step(cfg, T: int, eparams, state, x: torch.Tensor):
    """Block step, engine (C, T, B) convention: x (Cin, T, B) -> (y (Cout, T, B), state').
    A CUDA tensor goes through the kernel, a CPU tensor through ``step_plain``."""
    layout: Layout = eparams["layout"]
    if act.using_fast_tanh or act.lut_active():
        raise ValueError("fast-tanh / LUT mode was switched on after the fused engine was built")
    n = state["n"] % layout.wrap
    if x.is_cuda:
        y = launch(layout, eparams["weights"], eparams["plan"], state["buf"], x.contiguous(), n)
    elif x.device.type == "cpu":
        y = step_plain(layout, eparams["weights"], state["buf"], x, n)
    else:
        raise ValueError(f"fused stack step runs on CUDA or CPU tensors, got {x.device}")
    return y, {"buf": state["buf"], "n": (n + 1) % layout.wrap}


# =============================================================================
# Work counts, for the bound
# =============================================================================


def work(cfg, T: int, batch: int) -> Dict[str, float]:
    """What one block needs at the least: MACs, and the bytes that must move
    (input and output once; per layer, the 2*min(d, T) past frames its taps
    read and the min(rf, T) frames of new history, for C channels; weights
    once)."""
    macs = 0
    state_cols = 0
    for ac in cfg.layer_arrays:
        C, S = ac.channels, ac.condition_size
        macs += ac.input_size * C + C * ac.head_size
        for K, d in zip(ac.kernel_sizes, ac.dilations):
            macs += K * C * C + S * C + (C * C if ac.layer1x1_active else 0)
            rf = (K - 1) * d
            # distinct past frames the K taps read, and frames of new history
            past = len({t - (K - 1 - k) * d for k in range(K) for t in range(T)} & set(range(-rf, 0)))
            state_cols += C * (past + min(rf, T))
    n_weights = 0
    for ac in cfg.layer_arrays:
        C = ac.channels
        n_weights += ac.input_size * C + C * ac.head_size + ac.head_size
        for K in ac.kernel_sizes:
            n_weights += K * C * C + C + ac.condition_size * C + (C * C + C if ac.layer1x1_active else 0)
    per_stream = 4 * (state_cols + (cfg.in_channels + cfg.out_channels_) * T)
    return {
        "macs": float(macs * T * batch),
        "flops": float(2 * macs * T * batch),
        "bytes": float(per_stream * batch + 4 * n_weights),
    }
