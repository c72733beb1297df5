"""Fused WaveNet stack step: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_make_kernel`` of ``neuralampmodelercore_tpu/ops/
pallas/stack.py`` (its ``step`` reaches ``pl.pallas_call`` at stack.py:1769),
K1a-K1g in ROADMAP.md: every net, layer array and layer of one block in one
launch, with the state updated in place. The kernel is ``csrc/stack.cu``; its
header says what bounds it on an H100 and how the design answers that. With
``WAVEFRONT`` on, an eligible model runs ``csrc/stack_wf.cu`` instead (K1g):
the same step with each run of shallow layers scheduled in (layer, sub-tile)
micro-steps, on the same state.

The global fast-tanh and LUT modes (K1f) are baked in at ``prepare``: each
activation becomes a kernel code and its parameters
(``activations.kernel_code``), and ``step`` raises if the modes have changed
since.

What one launch runs (the JAX kernel's features, ``_build_plan`` stack.py:
625-909):

  - per layer: the dilated conv with ``conv_out`` = 2 * bottleneck rows when
    the layer is gated or blended, the input mixin, the activation or the
    gated / blended pair with its secondary activation (per-channel PReLU
    slopes included), layer1x1 (bottleneck -> channels), head1x1, and FiLM
    at any of the 8 sites (``FILM_SITES``);
  - per array: the head rechannel, a conv of any kernel size and dilation
    with rf <= T, its input history carried in the state;
  - per net: ``head_scale``, then the post-stack head (activation -> Conv1D,
    each conv with carried history);
  - nets: a chain of WaveNet condition DSPs runs in the same launch, deepest
    first, each on the raw input, each net's output the next net's
    condition (``_fused_chain`` stack.py:385-401). A condition DSP that is
    not a WaveNet runs first as a pre-pass through its own backend (its
    kernel when that kernel's ``supports`` passes on the card, else its
    torch engine tier); its output is the kernel's second input.

Engine-facing API (mirrors ``models.wavenet.engine_prepare/engine_step``):

    reason = supports(cfg, T, batch)       # None, or why the kernel refuses
    eparams, state = prepare(cfg, params, T, batch)
    y, state = step(cfg, T, eparams, state, x)   # x (Cin, T, B) -> y (Cout, T, B)

State is one flat float32 buffer holding a ring of M = rf // T + 2 whole
blocks, (M, C, T, B), for every conv with a receptive field (layers, head
rechannels, post-head convs), plus the block counter ``n``: a host integer
that wraps at the LCM of the ring sizes, so slot indices need no device
round trip; and, with a pre-pass, the condition model's own state. ``step``
writes the rings in place: the state passed in is consumed.

What ``csrc/stack.cu``'s register tile cannot hold -- more than 32 rows,
more than 4 input or condition channels, blocks of more than 512 frames --
runs on ``csrc/stack_wide.cu`` (the wide kernel): the same step on the same
plan, weights padded to WIDE_RW-row slices, and the same state, with every
row another slice or frame reads in shared memory; up to WIDE_MAX_ROWS rows,
WIDE_MAX_IN channels and WIDE_MAX_T frames. ``supports`` picks it only when
the register-tile kernel refuses the model; the layout records the choice.

On a CUDA tensor ``step`` launches the kernel (or raises); on a CPU tensor it
runs ``step_plain`` (``step_plain_wf`` for the wavefront path), the same step
on the same state layout in plain torch. ``launches`` counts launches of
all three kernels (``wf_launches`` those of the wavefront kernel,
``wide_launches`` those of the wide kernel) and nothing else.
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

#: Kernel launches so far (both kernels); the plain versions do not count.
launches = 0
#: Of those, launches of the wavefront kernel (csrc/stack_wf.cu).
wf_launches = 0
#: Of those, launches of the wide kernel (csrc/stack_wide.cu).
wide_launches = 0

#: Run an eligible model's shallow-layer runs in wavefront micro-steps (K1g).
#: Off by default, as in the JAX package (stack.py:430); read at every step,
#: so flipping it between blocks continues the same stream.
WAVEFRONT = False
WF_G = 4  # time sub-tiles of the wavefront path (stack.py:458)
WF_D = WF_G + 1  # layer-input slots: one sync per micro-step retires a slot's last read

MAX_T = 512  # one thread per (frame, stream); at most 512 threads per CTA
MAX_CHANNELS = 32  # register tile; a gated layer's conv has 2 * bottleneck rows
MAX_IN_CHANNELS = 4  # SMAX in stack.cu: input and condition channels
SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on Hopper
# The wide kernel (csrc/stack_wide.cu): weights padded to slices of WIDE_RW
# rows; its element-wise passes loop items of one (frame, stream, slice of
# WIDE_RW rows) over its threads.
WIDE_RW = 16  # RW in stack_wide.cu
WIDE_MAX_ROWS = 128
WIDE_MAX_IN = 8  # SW in stack_wide.cu
WIDE_MAX_T = 1024
WIDE_THREADS = 512
# Its layer phases' register tiles, (RT rows, FT columns) a thread: the
# kernel's instances, each with its most threads (__launch_bounds__).
WIDE_TILES = {(8, 2): 512, (8, 4): 256}
WIDE_TILE_REGS = {(8, 2): 128, (8, 4): 255}  # registers a thread of each instance (ptxas, PERF.md)

ACT_PRELU_CHANNELS = 11  # PReLU with one slope per channel (stack.cu's own activation code)
GATING_CODES = {"none": 0, "gated": 1, "blended": 2}

# Plan layout, as the constants in stack.cu.
P_HEADER, NF, AF, TF, LF = 8, 8, 10, 10, 34
N_FILM = 8  # FiLM sites, in FILM_SITES order


# =============================================================================
# Gate
# =============================================================================


def _pad4(c: int) -> int:
    """Register-tile width for c channels: 4, 8, 16 or 32."""
    for p in (4, 8, 16, 32):
        if c <= p:
            return p
    raise ValueError(f"{c} channels > {MAX_CHANNELS}")


def _streams_per_cta(T: int) -> int:
    return max(1, min(32, 512 // T))


def _act_reason(a, rows: int) -> Optional[str]:
    if a.type not in act.KERNEL_CODES:
        return f"activation {a.type} not in the kernel"
    if a.type == "PReLU" and rows % len(act.prelu_slopes(a)):
        return f"PReLU with {len(act.prelu_slopes(a))} slopes on {rows} channels"
    return None


def _limits(wide: bool) -> Tuple[int, int]:
    """(most rows, most input or condition channels) of a kernel."""
    return (WIDE_MAX_ROWS, WIDE_MAX_IN) if wide else (MAX_CHANNELS, MAX_IN_CHANNELS)


def _net_reason(cfg, T: int, S: int, wide: bool = True) -> Optional[str]:
    """Why the wide kernel (``wide``) or the register-tile kernel cannot run
    this WaveNet as one net with condition width S, or None. Covers
    everything but the condition DSP, the shared memory and the batch."""
    from ...models.wavenet import NONE, head_conv_specs

    max_rows, max_in = _limits(wide)
    if cfg.in_channels > max_in:
        return f"in_channels {cfg.in_channels} > {max_in}"
    if S > max_in:
        return f"condition channels {S} > {max_in}"
    for ai, ac in enumerate(cfg.layer_arrays):
        where = f"array {ai}"
        if ac.condition_size != S:
            return f"{where}: condition_size {ac.condition_size} != the condition's {S} channels"
        rows = max([ac.input_size, ac.channels, ac.head_size, ac.head_output_size]
                   + [ac.conv_out_channels(li) for li in range(ac.num_layers)])
        if rows > max_rows:
            return f"{where}: more than {max_rows} channels (a gated layer's conv counts 2 * bottleneck rows)"
        hr_rf = (ac.head_kernel_size - 1) * ac.head_dilation
        if hr_rf > T:
            return f"{where}: head rechannel receptive field {hr_rf} > T={T}"
        if ai + 1 < len(cfg.layer_arrays) and cfg.layer_arrays[ai + 1].head_output_size != ac.head_size:
            return f"{where}: head_size {ac.head_size} != the next array's head accumulator width"
        for li in range(ac.num_layers):
            bn = ac.bottleneck if ac.gating_modes[li] != NONE else ac.conv_out_channels(li)
            reason = _act_reason(ac.activations[li], bn)
            if reason is None and ac.gating_modes[li] != NONE:
                reason = _act_reason(ac.secondary_activations[li], bn)
            if reason is not None:
                return f"{where} layer {li}: {reason}"
    if cfg.head is not None:
        for spec in head_conv_specs(cfg.head):
            if spec.kernel_size - 1 > T:
                return f"post-stack head conv receptive field {spec.kernel_size - 1} > T={T}"
            if max(spec.in_channels, spec.out_channels) > max_rows:
                return f"post-stack head: more than {max_rows} channels"
            reason = _act_reason(cfg.head.activation, spec.in_channels)
            if reason is not None:
                return f"post-stack head: {reason}"
    return None


def _fused_chain(cfg, T: int) -> Optional[Tuple]:
    """The nested WaveNet condition DSPs, deepest first, when every one of
    them fuses into the launch as a prelude net; () without a condition DSP;
    None when the condition DSP runs as a pre-pass (stack.py:385-401)."""
    from ...models.wavenet import WaveNetConfig

    chain = []
    c = cfg.condition_config
    while c is not None:
        if not isinstance(c, WaveNetConfig):
            return None
        chain.append(c)
        c = c.condition_config
    chain.reverse()
    S = chain[0].in_channels if chain else 0
    for c in chain:  # the most either kernel runs: the launch then takes the wide one
        if _net_reason(c, T, S, wide=True) is not None:
            return None
        S = c.out_channels_
    return tuple(chain)


def cond_mode(cfg, T: int) -> str:
    """'none' | 'fused' (the condition chain runs inside the launch) |
    'prepass' (the condition model runs first; its output is the kernel's
    second input), as ``cond_mode`` in the JAX package (stack.py:404-409)."""
    if cfg.condition_config is None:
        return "none"
    return "fused" if _fused_chain(cfg, T) is not None else "prepass"


def _net_configs(cfg, T: int) -> Tuple[List, int]:
    """The WaveNets the launch runs, deepest condition first, and the width
    of the pre-pass condition input (0 without a pre-pass)."""
    chain = _fused_chain(cfg, T)
    if chain is None:
        return [cfg], cfg.layer_arrays[0].condition_size
    return list(chain) + [cfg], 0


def supports(cfg, T: int, batch: int) -> Optional[str]:
    """None if the kernel runs this (config, block size, batch), else the
    limit that refuses it. Every activation runs under the fast-tanh and LUT
    modes; with ``WAVEFRONT`` on, an eligible model must also fit the
    wavefront path's shared memory."""
    from ...models.wavenet import WaveNetConfig

    if not isinstance(cfg, WaveNetConfig):
        return f"not a WaveNetConfig: {type(cfg).__name__}"
    if batch < 1:
        return f"batch {batch} < 1"
    if not 1 <= T <= WIDE_MAX_T:
        return f"block size T={T} outside 1..{WIDE_MAX_T}"
    reason = _nets_reason(cfg, T, wide=True)
    if reason is not None:
        return reason
    nets = _net_configs(cfg, T)[0]
    if _is_wide(cfg, T):
        if not _wide_launch(nets, T)[0]:
            return f"shared memory {_wide_smem_bytes(nets, T, 1)} B > {SMEM_LIMIT} B at T={T} (wide kernel)"
        if WAVEFRONT and _wavefront_ineligible(cfg, T) is None:
            return ("wavefront path: the wide kernel has no wavefront schedule "
                    "(at most 32 rows, 4 input channels, T <= 512)")
        return None
    if WAVEFRONT and _wavefront_ineligible(cfg, T) is None and _wf_streams_per_cta(nets, T) == 0:
        return f"wavefront path: shared memory {_wf_smem_bytes(nets, T, 1)} B > {SMEM_LIMIT} B at T={T}"
    return None


def _nets_reason(cfg, T: int, wide: bool) -> Optional[str]:
    """``_net_reason`` of every net the launch runs: the fused condition
    chain, deepest first, each net's condition the previous one's output
    (the first one's the input or the pre-pass output), then the model."""
    nets, S_ext = _net_configs(cfg, T)
    S = S_ext or nets[0].in_channels
    for c in nets:
        reason = _net_reason(c, T, S, wide)
        if reason is not None:
            return reason
        S = c.out_channels_
    return None


def _is_wide(cfg, T: int) -> bool:
    """Whether the model needs the wide kernel (csrc/stack_wide.cu): the
    register-tile kernel (csrc/stack.cu) runs at most MAX_T frames,
    MAX_CHANNELS rows and MAX_IN_CHANNELS input channels in its shared
    memory."""
    return (T > MAX_T or _nets_reason(cfg, T, wide=False) is not None
            or _smem_bytes(_net_configs(cfg, T)[0], T) > SMEM_LIMIT)


# =============================================================================
# Wavefront gate and schedule (K1g)
# =============================================================================


def _wavefront_ineligible(cfg, T: int) -> Optional[str]:
    """``_wavefront_reason`` without the flag: None if the model's layer runs
    can be scheduled in micro-steps. The JAX gate (stack.py:464-502): the
    plain dilated stack without FiLM, gating, head1x1 or condition DSP, with
    a run of >= 2 consecutive shallow (rf <= T) layers."""
    from ...models.wavenet import FILM_SITES, NONE, layer_film_spec

    if getattr(cfg, "condition_config", None) is not None:
        return "condition DSP"
    if cfg.in_channels != 1:
        return "multi-channel input"
    if T % WF_G:
        return f"T={T} not divisible by G={WF_G}"
    packable = False
    for ac in cfg.layer_arrays:
        if ac.condition_size != 1:
            return "condition_size != 1"
        if ac.bottleneck != ac.channels:
            return "bottleneck != channels"
        if not ac.layer1x1_active:
            return "layer1x1 inactive"
        if ac.head1x1_active:
            return "head1x1 active"
        run = 0
        for li in range(ac.num_layers):
            if ac.gating_modes[li] != NONE:
                return "gating/blending"
            if any(layer_film_spec(ac, li, site) is not None for site in FILM_SITES):
                return "FiLM"
            rf = (ac.kernel_sizes[li] - 1) * ac.dilations[li]
            run = run + 1 if rf <= T else 0
            packable = packable or run >= 2
    if not packable:
        return "no run of >= 2 consecutive shallow layers to pack"
    return None


def _wavefront_reason(cfg, T: int) -> Optional[str]:
    """None if the wavefront path runs this model at block size T, else why
    not: the JAX package's verdict on every config (stack.py:464-502)."""
    if not WAVEFRONT:
        return "disabled"
    return _wavefront_ineligible(cfg, T)


def _wf_segments(ac, T: int) -> List[Tuple[str, object]]:
    """An array's layers as ("wf", [lis]) runs of >= 2 consecutive shallow
    layers and ("layer", li) whole-block singles (stack.py:505-527)."""
    segs: List[Tuple[str, object]] = []
    run: List[int] = []

    def flush():
        if len(run) >= 2:
            segs.append(("wf", list(run)))
        else:
            segs.extend(("layer", li) for li in run)
        run.clear()

    for li in range(ac.num_layers):
        if (ac.kernel_sizes[li] - 1) * ac.dilations[li] <= T:
            run.append(li)
        else:
            flush()
            segs.append(("layer", li))
    flush()
    return segs


def _wf_micros(ac, T: int) -> Tuple[Tuple[int, ...], ...]:
    """An array's micro-steps: per micro-step the array-local layer each of
    the WF_G sub-tiles runs (-1: idle). In a run, layer lis[j] runs on
    sub-tile tau at micro-step j + tau (the JAX plan's ``_WfMicro.active``);
    a whole-block layer runs on every sub-tile in one micro-step."""
    micros: List[Tuple[int, ...]] = []
    for kind, v in _wf_segments(ac, T):
        if kind == "layer":
            micros.append((v,) * WF_G)
            continue
        micros += [tuple(v[m - tau] if 0 <= m - tau < len(v) else -1 for tau in range(WF_G))
                   for m in range(len(v) + WF_G - 1)]
    return tuple(micros)


def _wf_smem_bytes(nets, T: int, BS: int) -> int:
    """WF_G + 1 weight segments (the G layers in flight and the next one)
    and WF_D (rows, T, BS) layer-input slots."""
    seg_max, rows = _smem_sizes(nets)
    return 4 * ((WF_G + 1) * seg_max + WF_D * rows * T * BS)


def _wf_streams_per_cta(nets, T: int) -> int:
    """The unpacked kernel's streams per CTA, fewer where the wavefront
    path's shared memory needs it; 0 if even one stream does not fit."""
    BS = _streams_per_cta(T)
    while BS and _wf_smem_bytes(nets, T, BS) > SMEM_LIMIT:
        BS -= 1
    return BS


# =============================================================================
# Layout: packed weights, plan and state offsets
# =============================================================================


def _array_tile(ac, wide: bool = False) -> int:
    """Padded rows CP of an array: its channels, bottleneck, conv rows and
    head1x1 rows. A gated layer's two halves sit at [0, bn) and [CP/2,
    CP/2 + bn): CP >= 2 bn, so CP/2 >= bn. The register-tile kernel pads to
    4, 8, 16 or 32; the wide kernel to a multiple of WIDE_RW, so that a
    gated layer's halves split into slices of WIDE_RW / 2 rows."""
    rows = [ac.channels, ac.bottleneck] + [ac.conv_out_channels(li) for li in range(ac.num_layers)]
    if ac.head1x1_active:
        rows.append(ac.head1x1_out_channels)
    return -(-max(rows) // WIDE_RW) * WIDE_RW if wide else _pad4(max(rows))


def _prm_width(CP: int) -> int:
    """Parameter floats of a layer's activation: one slope per row for
    per-channel PReLU, at least ``activations.KERNEL_PARAMS`` (a LUT's)."""
    return max(CP, act.KERNEL_PARAMS)


def _segment_parts(ac, li: int, CP: int, SW: int = MAX_IN_CHANNELS) -> List[Tuple[str, int]]:
    """(name, floats) of a layer's weight segment, in order; every part a
    multiple of 4 floats, so each starts 16-byte aligned. SW: the condition
    width input_mixin_pre_film's weights are padded to (the kernel's most
    input channels)."""
    from ...models.wavenet import FILM_SITES, layer_film_spec

    K, C, S = ac.kernel_sizes[li], ac.channels, ac.condition_size
    parts = [("conv", K * C * CP), ("b", CP), ("mix", S * CP)]
    if ac.layer1x1_active:
        parts += [("l1", CP * CP), ("l1b", CP)]
    if ac.head1x1_active:
        parts += [("h1", CP * CP), ("h1b", CP)]
    parts += [("prm1", _prm_width(CP)), ("prm2", _prm_width(CP))]
    for site in FILM_SITES:
        spec = layer_film_spec(ac, li, site)
        if spec is not None:
            W = SW if site == "input_mixin_pre_film" else CP
            parts.append((site, (2 if spec.shift else 1) * (S * W + W)))
    return parts


def _tail_outs(cfg) -> List[int]:
    """Output rows of each conv of ``_tail_specs``, in its order."""
    from ...models.wavenet import head_conv_specs

    out = [ac.head_size for ac in cfg.layer_arrays]
    if cfg.head is not None:
        out += [s.out_channels for s in head_conv_specs(cfg.head)]
    return out


def _tail_specs(cfg) -> List[Tuple[int, int, int]]:
    """(K, d, cin) of each conv with carried history outside the layers:
    head rechannels, then post-stack head convs."""
    from ...models.wavenet import head_conv_specs

    out = [(ac.head_kernel_size, ac.head_dilation, ac.head_output_size) for ac in cfg.layer_arrays]
    if cfg.head is not None:
        out += [(s.kernel_size, s.dilation, s.in_channels) for s in head_conv_specs(cfg.head)]
    return out


def _smem_sizes(nets) -> Tuple[int, int]:
    """(largest weight segment in floats, rows of the shared input buffer:
    every layer's channels and every tail conv's input, which tail_conv
    publishes there whatever its kernel size)."""
    seg_max = max(
        (sum(n for _, n in _segment_parts(ac, li, _array_tile(ac)))
         for cfg in nets for ac in cfg.layer_arrays for li in range(ac.num_layers)),
        default=4,
    )
    rows = [ac.channels for cfg in nets for ac in cfg.layer_arrays]
    rows += [cin for cfg in nets for _, _, cin in _tail_specs(cfg)]
    return seg_max, max(rows)


def _smem_bytes(nets, T: int) -> int:
    """Two weight segments, and the double-buffered (rows, T, streams) input
    of the layer (or of a tail conv) that neighbouring frames' taps read."""
    seg_max, rows = _smem_sizes(nets)
    return 4 * (2 * seg_max + 2 * rows * T * _streams_per_cta(T))


def _wide_sizes(nets) -> Tuple[int, int, bool]:
    """The wide kernel's shared buffers: (rows of the layer input,
    activation and head accumulator buffers, a multiple of WIDE_RW; rows of
    the condition buffer; whether a layer has conv_pre_film, which adds a
    buffer for the filmed input)."""
    from ...models.wavenet import layer_film_spec

    rows = [_array_tile(ac, wide=True) for cfg in nets for ac in cfg.layer_arrays]
    rows += [max(cin, cout) for cfg in nets for (_, _, cin), cout in zip(_tail_specs(cfg), _tail_outs(cfg))]
    srows = max(max(cfg.layer_arrays[0].condition_size for cfg in nets), 1)
    film_pre = any(layer_film_spec(ac, li, "conv_pre_film") is not None
                   for cfg in nets for ac in cfg.layer_arrays for li in range(ac.num_layers))
    return -(-max(rows) // WIDE_RW) * WIDE_RW, srows, film_pre


def _wide_seg_max(nets) -> int:
    """Floats of the largest weight segment in the wide kernel's layout."""
    return max((sum(n for _, n in _segment_parts(ac, li, _array_tile(ac, wide=True), WIDE_MAX_IN))
                for cfg in nets for ac in cfg.layer_arrays for li in range(ac.num_layers)), default=4)


def _wide_tap_floats(nets, T: int, BS: int) -> int:
    """Floats of the wide kernel's staged taps: a layer's (K-1) C T BS at the most."""
    return max(((ac.kernel_sizes[li] - 1) * ac.channels * T * BS
                for cfg in nets for ac in cfg.layer_arrays for li in range(ac.num_layers)), default=0)


def _wide_smem_bytes(nets, T: int, BS: int, staged: bool = False, taps: bool = False) -> int:
    """Three (rows, T, BS) buffers, the condition's and conv_pre_film's, with
    ``staged`` a layer's weight segment and with ``taps`` its staged taps."""
    rows, srows, film_pre = _wide_sizes(nets)
    return 4 * (T * BS * ((4 if film_pre else 3) * rows + srows) + (_wide_seg_max(nets) if staged else 0)
                + (_wide_tap_floats(nets, T, BS) if taps else 0))


def wide_fit(T: int, rows: int, smem_bytes) -> Tuple[int, bool]:
    """(streams per CTA, whether the weights are staged in shared memory) of a
    wide kernel (stack_wide.cu, convnet_wide.cu) whose buffers have ``rows``
    rows and take ``smem_bytes(BS, staged)``: enough items of (frame, stream,
    slice of WIDE_RW rows) for WIDE_THREADS threads where shared memory
    allows, the weights staged where they fit beside one stream's buffers;
    (0, False) if one stream's buffers do not fit."""
    for staged in (True, False):
        BS = max(1, WIDE_THREADS // (T * (rows // WIDE_RW)))
        while BS and smem_bytes(BS, staged) > SMEM_LIMIT:
            BS -= 1
        if BS:
            return BS, staged
    return 0, False


def _wide_launch(nets, T: int) -> Tuple[int, bool, bool]:
    """(streams per CTA, whether the weights and whether the taps are staged
    in shared memory) of the wide stack kernel: ``wide_fit``'s streams and
    weights (enough items of WIDE_RW rows for WIDE_THREADS threads, the
    weights staged where they fit beside one stream's buffers), then the
    taps staged where they fit too; (0, False, False) if one stream's
    buffers do not fit. The ConvNet's wide kernel keeps ``wide_fit``."""
    rows = _wide_sizes(nets)[0]
    for staged in (True, False):
        BS = max(1, WIDE_THREADS // (T * (rows // WIDE_RW)))
        while BS:
            for taps in (True, False):
                if _wide_smem_bytes(nets, T, BS, staged, taps) <= SMEM_LIMIT:
                    return BS, staged, taps
            BS -= 1
    return 0, False, False


def _wide_slices(ac, li: int, RT: int) -> Tuple[int, int, int]:
    """Slices of RT rows that layer li's phases F, A and B compute in the
    wide kernel (``phases`` in stack_wide.cu): F the layer input's rows (0
    without conv_pre_film); A the conv's real rows (a gated slice holds RT/2
    rows of each half) and the input's rows for the ring; B the rows of
    layer1x1's output (the channels) and of the head's (head_output_size)."""
    from ...models.wavenet import NONE, layer_film_spec

    C, bn = ac.channels, ac.bottleneck
    n_c = -(-C // RT)
    f = n_c if layer_film_spec(ac, li, "conv_pre_film") is not None else 0
    a = max(-(-bn // (RT // 2 if ac.gating_modes[li] != NONE else RT)), n_c)
    b = -(-max(C if ac.layer1x1_active else 0, ac.head_output_size) // RT)
    return f, a, b


def _wide_items(n_slices: int, TBS: int, FT: int) -> int:
    """Items (a thread's slice and FT columns) of a phase of n_slices slices
    over TBS columns: a warp takes one slice and 32 FT columns
    (``phase_map``)."""
    return -(-TBS // (32 * FT)) * n_slices * 32


def _wide_threads(nets, T: int, BS: int, tile: Tuple[int, int]) -> int:
    """Threads of the wide kernel's CTA: the most items a layer phase has,
    at most the tile instance's threads."""
    RT, FT = tile
    items = max((_wide_items(n, T * BS, FT) for cfg in nets for ac in cfg.layer_arrays
                 for li in range(ac.num_layers) for n in _wide_slices(ac, li, RT) if n), default=32)
    return min(WIDE_TILES[tile], items)


SM_SMEM, SM_THREADS, SM_REGS = 233472, 2048, 65536  # one Hopper SM; a CTA also takes 1 KB of shared memory


def wide_ctas_per_sm(layout: "Layout") -> int:
    """CTAs of the wide kernel one SM holds at once: bound by shared memory,
    threads and registers (the instance's, ``WIDE_TILE_REGS``, allocated in
    256 a warp). ``wide_ctas_per_sm_runtime`` asks the CUDA runtime."""
    wd = layout.wide
    warps = -(-wd.threads // 32)
    regs_warp = -(-WIDE_TILE_REGS[wd.tile] * 32 // 256) * 256
    return min(SM_SMEM // (layout.smem_bytes + 1024), SM_THREADS // (32 * warps), SM_REGS // (regs_warp * warps))


def wide_ctas_per_sm_runtime(layout: "Layout") -> int:
    """The CUDA runtime's count of the layout's wide-kernel CTAs an SM holds (on the card)."""
    wd = layout.wide
    return WIDE_LIB.load().nam_stack_wide_ctas_per_sm(*wd.tile, wd.threads, layout.smem_bytes)


def _wide_tile(taps: bool) -> Tuple[int, int]:
    """The register tile the wrapper picks for the wide kernel: 8 x 2 (16
    warps at 128 columns) where the taps are staged and the conv reads only
    shared memory, else 8 x 4 (each tap where it lies: more loads in flight
    a thread), as ``tools/stack_wide_tiles.py`` measured on LARGE, gated
    MEDIUM and the flagship at T = 1,024, whose taps do not fit (PERF.md)."""
    return (8, 2) if taps else (8, 4)


@dataclasses.dataclass(frozen=True)
class TailLayout:
    """A conv with carried history outside the layer loop: a head rechannel
    or a post-stack head conv, (K * cin, cout) weights row-major."""

    K: int
    d: int
    cin: int
    cout: int
    w: int
    b: int  # -1: no bias
    M: int  # ring slots; 0 => no ring (rf == 0)
    ring: int
    act: int  # activation code applied to the input first (post head), -1 none
    prm: int  # its parameters (MAX_CHANNELS floats), -1 none


@dataclasses.dataclass(frozen=True)
class LayerLayout:
    K: int
    d: int
    M: int  # ring slots; 0 => no ring (rf == 0)
    ring: int  # float offset of the (M, C, T, B) ring in the state buffer
    seg: int  # float offset of the weight segment
    seg_len: int
    gating: int  # GATING_CODES
    act1: int
    act2: int
    offs: Dict[str, int]  # part -> float offset inside the segment (absent: inactive)
    shifts: Tuple[bool, ...]  # per FiLM site


@dataclasses.dataclass(frozen=True)
class ArrayLayout:
    C: int
    CP: int
    I: int
    HI: int  # head accumulator rows (head_output_size)
    HS: int  # head rechannel output rows (head_size)
    rech: int  # (C, I)
    first: int  # global index of the first layer
    layers: Tuple[LayerLayout, ...]
    hr: TailLayout
    BN: int  # bottleneck: the activation rows of every layer


@dataclasses.dataclass(frozen=True)
class NetLayout:
    S: int  # condition width
    Cout: int
    head_scale: int
    arrays: Tuple[ArrayLayout, ...]
    pheads: Tuple[TailLayout, ...]


@dataclasses.dataclass(frozen=True)
class WfLayout:
    """The wavefront path (K1g): its launch shape and its schedule."""

    BS: int  # streams per CTA (fewer than the unpacked kernel's where shared memory needs it)
    smem_bytes: int
    rows: int  # channel rows of one layer-input slot
    micros: Tuple[Tuple[Tuple[int, ...], ...], ...]  # per array: ``_wf_micros``


@dataclasses.dataclass(frozen=True)
class WideLayout:
    """The wide kernel (csrc/stack_wide.cu): its shared buffers and launch shape."""

    rows: int  # rows of the layer input, activation and head accumulator buffers
    srows: int  # rows of the condition buffer
    film_pre: bool  # a conv_pre_film buffer
    threads: int
    seg_max: int  # floats of the staged weight segment; 0: the weights are read from device memory
    tile: Tuple[int, int]  # (RT rows, FT columns) a thread in the layer phases: the kernel instance
    tap_max: int  # floats of the staged taps ((K-1) C T BS at the most); 0: taps are read where they lie


@dataclasses.dataclass(frozen=True)
class Layout:
    T: int
    B: int
    BS: int
    Cin: int
    Cout: int
    S_ext: int  # width of the pre-pass condition input, 0 if none
    c_max: int  # register tile of the kernel instance (4/8/16/32); WIDE_RW for the wide kernel
    seg_max: int
    state_size: int
    wrap: int
    smem_bytes: int
    nets: Tuple[NetLayout, ...]
    modes: Tuple  # activations.modes() the activation codes were resolved under
    wf: Optional[WfLayout]  # None: the model is not eligible for the wavefront path (or does not fit)
    wide: Optional["WideLayout"] = None  # the wide kernel's launch shape; None: csrc/stack.cu runs the model

    @property
    def sw(self) -> int:
        """Columns of input_mixin_pre_film's weights: the kernel's most input channels."""
        return WIDE_MAX_IN if self.wide else MAX_IN_CHANNELS

    @property
    def tail_prm(self) -> int:
        """Parameter floats of a post-head activation: a slope per row at most."""
        return WIDE_MAX_ROWS if self.wide else MAX_CHANNELS

    @property
    def arrays(self) -> Tuple[ArrayLayout, ...]:
        return tuple(a for net in self.nets for a in net.arrays)

    @property
    def layers(self) -> Tuple[LayerLayout, ...]:
        return tuple(lp for a in self.arrays for lp in a.layers)

    @property
    def tails(self) -> Tuple[TailLayout, ...]:
        return tuple(a.hr for a in self.arrays) + tuple(t for net in self.nets for t in net.pheads)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _dense_1x1(p: Dict) -> np.ndarray:
    """Dense (in, out) weight of conv1x1 params (depthwise -> diagonal;
    grouped weights are stored dense block-diagonal)."""
    return np.diag(_np(p["dw"])) if "dw" in p else _np(p["w"])


def _dense_conv(p: Dict) -> np.ndarray:
    """Dense (K, in, out) weight of conv1d params (depthwise -> per-tap diagonal)."""
    if "dw" not in p:
        return _np(p["w"])
    dw = _np(p["dw"])  # (K, C)
    return np.stack([np.diag(dw[k]) for k in range(dw.shape[0])])


def _act_code_prm(a, rows: int, width: int) -> Tuple[int, np.ndarray]:
    """Kernel code and ``width`` parameter floats of an activation applied to
    ``rows`` channels, under the current global modes: per-channel PReLU
    slopes repeat along the channels (channel c takes slope c mod n, as
    ``activations.apply``); every other activation as
    ``activations.kernel_code`` resolves it."""
    prm = np.zeros(width, np.float32)
    slopes = act.prelu_slopes(a) if a.type == "PReLU" else ()
    if len(slopes) > 1:
        prm[:rows] = [slopes[c % len(slopes)] for c in range(rows)]
        return ACT_PRELU_CHANNELS, prm
    code, prm[: act.KERNEL_PARAMS] = act.kernel_code(a)
    return code, prm


def _layer_parts(ac, li: int, lp: Dict, CP: int, SW: int):
    """A layer's weight segment parts (as ``_segment_parts`` names them),
    padded to the register tile, and its activation codes and FiLM shift
    flags. A gated or blended layer's conv rows go [top | bottom] at [0, bn)
    and [CP/2, CP/2 + bn)."""
    from ...models.wavenet import FILM_SITES, NONE, layer_film_spec

    K, C, S, bn = ac.kernel_sizes[li], ac.channels, ac.condition_size, ac.bottleneck
    gating = ac.gating_modes[li]
    conv_out = ac.conv_out_channels(li)
    # Row of each conv output: a gated layer's second half goes to CP/2.
    pos = np.arange(conv_out)
    if gating != NONE:
        pos = np.where(pos < bn, pos, CP // 2 + pos - bn)
    act_rows = conv_out if gating == NONE else bn
    parts: Dict[str, np.ndarray] = {}
    conv = np.zeros((K * C, CP), np.float32)
    conv[:, pos] = _dense_conv(lp["conv"]).reshape(K * C, conv_out)
    parts["conv"] = conv
    parts["b"] = np.zeros(CP, np.float32)
    parts["b"][pos] = _np(lp["conv"]["b"])
    parts["mix"] = np.zeros((S, CP), np.float32)
    parts["mix"][:, pos] = _dense_1x1(lp["mixin"])
    if ac.layer1x1_active:
        parts["l1"] = np.zeros((CP, CP), np.float32)
        parts["l1"][:bn, :C] = _dense_1x1(lp["layer1x1"])  # (bn, C)
        parts["l1b"] = np.zeros(CP, np.float32)
        parts["l1b"][:C] = _np(lp["layer1x1"]["b"])
    if ac.head1x1_active:
        HO = ac.head1x1_out_channels
        parts["h1"] = np.zeros((CP, CP), np.float32)
        parts["h1"][:bn, :HO] = _dense_1x1(lp["head1x1"])  # (bn, HO)
        parts["h1b"] = np.zeros(CP, np.float32)
        parts["h1b"][:HO] = _np(lp["head1x1"]["b"])
    act1, parts["prm1"] = _act_code_prm(ac.activations[li], act_rows, _prm_width(CP))
    act2, parts["prm2"] = _act_code_prm(ac.secondary_activations[li], act_rows, _prm_width(CP))
    shifts = []
    for site in FILM_SITES:
        spec = layer_film_spec(ac, li, site)
        shifts.append(bool(spec is not None and spec.shift))
        if spec is None:
            continue
        dim = spec.input_dim
        W = SW if site == "input_mixin_pre_film" else CP
        rows = pos if site in ("conv_post_film", "input_mixin_post_film", "activation_pre_film") \
            else np.arange(dim)
        dense = _dense_1x1(lp[site])  # (S, (2 if shift else 1) * dim)
        bias = _np(lp[site]["b"])
        film = []
        for h in range(2 if spec.shift else 1):  # scale, then shift
            fw, fb = np.zeros((S, W), np.float32), np.zeros(W, np.float32)
            fw[:, rows] = dense[:, h * dim : (h + 1) * dim]
            fb[rows] = bias[h * dim : (h + 1) * dim]
            film += [fw.reshape(-1), fb]
        parts[site] = np.concatenate(film)
    return parts, act1, act2, tuple(shifts)


def _build_layout(cfg, params, T: int, batch: int,
                  wide_tile: Optional[Tuple[int, int]] = None) -> Tuple[Layout, np.ndarray]:
    """Pack every weight into one flat float32 array (each part 16-byte
    aligned) and assign ring offsets in the flat state buffer. ``wide_tile``
    forces the wide kernel's register tile (else ``_wide_tile`` picks it)."""
    from ...models.wavenet import head_conv_specs

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

    state_size = 0
    wrap = 1
    wide = _is_wide(cfg, T)
    SW, tail_prm = (WIDE_MAX_IN, WIDE_MAX_ROWS) if wide else (MAX_IN_CHANNELS, MAX_CHANNELS)

    def ring(K: int, d: int, rows: int) -> Tuple[int, int]:
        nonlocal state_size, wrap
        rf = (K - 1) * d
        if rf == 0:
            return 0, 0
        M = rf // T + 2
        off = state_size
        state_size += M * rows * T * batch
        wrap = wrap * M // math.gcd(wrap, M)
        return M, off

    def tail(p: Dict, K: int, d: int, cin: int, cout: int, act_cfg=None) -> TailLayout:
        w = put(_dense_conv(p).reshape(K * cin, cout))
        b = put(_np(p["b"])) if "b" in p else -1
        M, off = ring(K, d, cin)
        code, prm = -1, -1
        if act_cfg is not None:
            code, prm_a = _act_code_prm(act_cfg, cin, tail_prm)
            prm = put(prm_a)
        return TailLayout(K=K, d=d, cin=cin, cout=cout, w=w, b=b, M=M, ring=off, act=code, prm=prm)

    # The fused condition chain, deepest first, then the model itself.
    net_cfgs, S_ext = _net_configs(cfg, T)
    net_params = [params]
    for _ in net_cfgs[1:]:
        net_params.insert(0, net_params[0]["condition"])
    nets: List[NetLayout] = []
    n_layers = 0
    for ncfg, nparams in zip(net_cfgs, net_params):
        S = ncfg.layer_arrays[0].condition_size
        arrays: List[ArrayLayout] = []
        for ai, ac in enumerate(ncfg.layer_arrays):
            ap = nparams["arrays"][ai]
            C, CP = ac.channels, _array_tile(ac, wide)
            rech = put(_dense_1x1(ap["rechannel"]).T)  # (C, I)
            layers: List[LayerLayout] = []
            for li in range(ac.num_layers):
                lp = ap["layers"][li]
                K, d = ac.kernel_sizes[li], ac.dilations[li]
                parts, act1, act2, shifts = _layer_parts(ac, li, lp, CP, SW)
                offs, flat, at = {}, [], 0
                for name, n in _segment_parts(ac, li, CP, SW):
                    a = parts[name].reshape(-1)
                    assert a.size == n, (name, a.size, n)
                    offs[name] = at
                    flat.append(a)
                    at += n
                M, roff = ring(K, d, C)
                layers.append(LayerLayout(
                    K=K, d=d, M=M, ring=roff, seg=put(np.concatenate(flat)), seg_len=at,
                    gating=GATING_CODES[ac.gating_modes[li]], act1=act1, act2=act2, offs=offs, shifts=shifts,
                ))
            hr = tail(ap["head_rechannel"], ac.head_kernel_size, ac.head_dilation, ac.head_output_size, ac.head_size)
            arrays.append(ArrayLayout(
                C=C, CP=CP, I=ac.input_size, HI=ac.head_output_size, HS=ac.head_size, rech=rech,
                first=n_layers, layers=tuple(layers), hr=hr, BN=ac.bottleneck,
            ))
            n_layers += len(layers)
        head_scale = put(np.asarray([float(_np(nparams["head_scale"]))], np.float32))
        pheads = ()
        if ncfg.head is not None:
            pheads = tuple(
                tail(nparams["head"][si], s.kernel_size, s.dilation, s.in_channels, s.out_channels,
                     ncfg.head.activation)
                for si, s in enumerate(head_conv_specs(ncfg.head))
            )
        nets.append(NetLayout(S=S, Cout=ncfg.out_channels_, head_scale=head_scale, arrays=tuple(arrays),
                              pheads=pheads))
    seg_max = max(lp.seg_len for n in nets for a in n.arrays for lp in a.layers) if n_layers else 4
    if wide:
        rows, srows, film_pre = _wide_sizes(net_cfgs)
        BS, staged, taps = _wide_launch(net_cfgs, T)
        tile = wide_tile or _wide_tile(taps)
        if tile not in WIDE_TILES:
            raise ValueError(f"wide_tile {tile}: the wide kernel's tiles are {sorted(WIDE_TILES)}")
        layout = Layout(
            T=T, B=batch, BS=BS, Cin=cfg.in_channels, Cout=cfg.out_channels_, S_ext=S_ext, c_max=WIDE_RW,
            seg_max=seg_max, state_size=state_size, wrap=wrap,
            smem_bytes=_wide_smem_bytes(net_cfgs, T, BS, staged, taps),
            nets=tuple(nets), modes=act.modes(), wf=None,
            wide=WideLayout(rows=rows, srows=srows, film_pre=film_pre, threads=_wide_threads(net_cfgs, T, BS, tile),
                            seg_max=seg_max if staged else 0, tile=tile,
                            tap_max=_wide_tap_floats(net_cfgs, T, BS) if taps else 0),
        )
        return layout, np.concatenate(chunks)
    widths = [cfg.in_channels, S_ext] + [n.S for n in nets]
    widths += [w for n in nets for a in n.arrays for w in (a.CP, a.I, a.HI, a.HS)]
    widths += [w for n in nets for t in n.pheads for w in (t.cin, t.cout)]
    # The wavefront path is laid out whenever the model is eligible, so that
    # WAVEFRONT may be switched on between blocks.
    wf = None
    BS_wf = _wf_streams_per_cta(net_cfgs, T)
    if _wavefront_ineligible(cfg, T) is None and BS_wf:
        wf = WfLayout(BS=BS_wf, smem_bytes=_wf_smem_bytes(net_cfgs, T, BS_wf), rows=_smem_sizes(net_cfgs)[1],
                      micros=tuple(_wf_micros(ac, T) for ac in cfg.layer_arrays))
    layout = Layout(
        T=T, B=batch, BS=_streams_per_cta(T), Cin=cfg.in_channels, Cout=cfg.out_channels_, S_ext=S_ext,
        c_max=_pad4(max(widths)), seg_max=seg_max, state_size=state_size, wrap=wrap,
        smem_bytes=_smem_bytes(net_cfgs, T), nets=tuple(nets), modes=act.modes(), wf=wf,
    )
    return layout, np.concatenate(chunks)


def _pack_plan(layout: Layout) -> np.ndarray:
    """The int64 plan the kernel reads (field order as in stack.cu): header,
    nets, arrays, tail convs, layers."""
    from ...models.wavenet import FILM_SITES

    arrays, tails, layers = layout.arrays, layout.tails, layout.layers
    tail_index = {id(t): i for i, t in enumerate(tails)}
    plan = np.zeros(P_HEADER + NF * len(layout.nets) + AF * len(arrays) + TF * len(tails) + LF * len(layers),
                    np.int64)
    plan[:P_HEADER] = [len(layout.nets), len(arrays), len(tails), len(layers), layout.Cin, layout.Cout,
                       layout.seg_max, layout.S_ext]
    at, first_array = P_HEADER, 0
    for net in layout.nets:
        ph = [tail_index[id(t)] for t in net.pheads]
        plan[at : at + 7] = [first_array, len(net.arrays), net.S, net.Cout, net.head_scale,
                             ph[0] if ph else 0, len(ph)]
        at += NF
        first_array += len(net.arrays)
    for a in arrays:
        plan[at : at + AF] = [a.C, a.CP, a.I, a.HI, a.HS, a.rech, a.first, len(a.layers), tail_index[id(a.hr)], a.BN]
        at += AF
    for t in tails:
        plan[at : at + TF] = [t.K, t.d, t.cin, t.cout, t.w, t.b, t.M, t.ring, t.act, t.prm]
        at += TF
    for lp in layers:
        o = lp.offs
        plan[at : at + 17] = [lp.K, lp.d, lp.M, lp.ring, lp.seg, lp.seg_len, lp.act1, lp.act2, lp.gating,
                              o["b"], o["mix"], o.get("l1", -1), o.get("l1b", -1), o.get("h1", -1),
                              o.get("h1b", -1), o["prm1"], o["prm2"]]
        plan[at + 17 : at + 17 + N_FILM] = [o.get(site, -1) for site in FILM_SITES]
        plan[at + 17 + N_FILM : at + 17 + 2 * N_FILM] = lp.shifts
        # Whether the layer uses gating, FiLM or head1x1 (else the kernel's short branch).
        plan[at + 17 + 2 * N_FILM] = int(lp.gating != 0 or "h1" in o or any(s in o for s in FILM_SITES))
        at += LF
    return plan


def _wf_rows(layout: Layout) -> Tuple[List[List[int]], List[int]]:
    """Every array's micro-steps in launch order, each as the global layer
    per sub-tile (-1 idle), and the layer whose weights each micro-step
    stages for the next one (-1 none; layer 0 is staged before the first).
    A layer's weights go to buffer (layer mod WF_G + 1); the asserts check
    that no buffer is restaged while a layer still reads it."""
    Tg = layout.T // WF_G
    for a, micros in zip(layout.arrays, layout.wf.micros):
        for m in micros:
            # A pair reads its layer's slot on its own sub-tile and the ones
            # its taps reach back to, and writes the next slot on its own:
            # no pair of a micro-step may write what another one reads.
            reads = {(li % WF_D, u) for tau, li in enumerate(m) if li >= 0
                     for u in range(max(0, tau - -(-(a.layers[li].K - 1) * a.layers[li].d // Tg)), tau + 1)}
            writes = {((li + 1) % WF_D, tau) for tau, li in enumerate(m) if li >= 0}
            assert not reads & writes, "a micro-step writes a layer-input slot that it reads"
    rows = [[a.first + li if li >= 0 else -1 for li in m]
            for a, micros in zip(layout.arrays, layout.wf.micros) for m in micros]
    first_use: Dict[int, int] = {}
    last_use: Dict[int, int] = {}
    for r, row in enumerate(rows):
        for g in row:
            if g >= 0:
                first_use.setdefault(g, r)
                last_use[g] = r
    stage = [-1] * len(rows)
    assert first_use[0] == 0
    for g, r in first_use.items():
        if g:
            assert stage[r - 1] == -1, "two layers staged in one micro-step"
            stage[r - 1] = g
        later = first_use.get(g + WF_G + 1)
        assert later is None or later - 1 > last_use[g], "weight buffer restaged while in use"
    return rows, stage


def _pack_wf(layout: Layout) -> np.ndarray:
    """The int64 schedule the wavefront kernel reads (as in stack_wf.cu):
    [G, D, slot rows, n_arrays], per array (first micro-step, count), then
    per micro-step the G sub-tiles' global layers and the layer to stage."""
    rows, stage = _wf_rows(layout)
    head = [WF_G, WF_D, layout.wf.rows, len(layout.arrays)]
    at = 0
    for micros in layout.wf.micros:
        head += [at, len(micros)]
        at += len(micros)
    return np.asarray(head + [v for row, s in zip(rows, stage) for v in row + [s]], np.int64)


def _prepass_fns(sub_cfg, T: int, batch: int, device: torch.device):
    """(prepare, step) of a pre-pass condition model, by the auto rule: its
    kernel when it has one that runs this config on the card, else its torch
    engine tier (which runs on the card too)."""
    from ... import registry
    from . import backend_for

    if device.type == "cuda":
        try:
            backend = backend_for(sub_cfg)
        except NotImplementedError:
            backend = None
        if backend is not None and backend.supports(sub_cfg, T, batch) is None:
            return backend.prepare, backend.step
    return registry.engine_fns(registry.arch_for_config(sub_cfg))


def prepare(cfg, params, T: int, batch: int, wide_tile: Optional[Tuple[int, int]] = None):
    """Packed weights, plan and zero state on the params' device.
    ``wide_tile`` (RT, FT) forces the wide kernel's register tile, for tests
    and measurements (it must be one of WIDE_TILES); it is ignored where
    csrc/stack.cu runs the model."""
    reason = supports(cfg, T, batch)
    if reason is not None:
        raise ValueError(f"fused stack kernel does not support this config: {reason}")
    device = params["head_scale"].device
    layout, flat = _build_layout(cfg, params, T, batch, wide_tile)
    eparams = {
        "layout": layout,
        "weights": torch.tensor(flat, device=device),
        "plan": torch.tensor(_pack_plan(layout), device=device),
    }
    if layout.wf is not None:
        eparams["wf_sched"] = torch.tensor(_pack_wf(layout), device=device)
    state = {"buf": torch.zeros(max(layout.state_size, 1), device=device), "n": 0}
    if layout.S_ext:
        sub_prepare, sub_step = _prepass_fns(cfg.condition_config, T, batch, device)
        sub_ep, state["condition"] = sub_prepare(cfg.condition_config, params["condition"], T, batch)
        eparams["condition"] = (sub_step, sub_ep)
    return eparams, state


# =============================================================================
# Plain version: the same step on the same state layout, in torch
# =============================================================================


def _act_plain(code: int, prm: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's activation ``code`` with its parameters, on (C, T, B)."""
    if code == ACT_PRELU_CHANNELS:
        return torch.where(v > 0, v, prm[: v.shape[0], None, None] * v)
    return act.kernel_apply(code, prm, v)


def step_plain(layout: Layout, weights: torch.Tensor, buf: torch.Tensor, x: torch.Tensor, n: int,
               cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block through every net, reading the weights back out of the
    packed buffer and writing the rings in place. x (Cin, T, B) and, with a
    pre-pass, cond (S_ext, T, B) -> (Cout, T, B). Stage order as the JAX
    kernel's (stack.py:1551-1641)."""
    return _plain(layout, weights, buf, x, n, cond, wavefront=False)


def step_plain_wf(layout: Layout, weights: torch.Tensor, buf: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """The wavefront path's plain version: ``step_plain`` with every array's
    layers run in the micro-step schedule of ``layout.wf``, each (layer,
    sub-tile) pair on its sub-tile's frames, reading its layer input from one
    of WF_D slots as the kernel does. All pairs of a micro-step read before
    any of them writes, so a schedule whose pairs depend on each other (or a
    slot reused too early) gives another result. Same state layout."""
    if layout.wf is None:
        raise ValueError("this model has no wavefront path (see _wavefront_reason)")
    return _plain(layout, weights, buf, x, n, None, wavefront=True)


def _plain(layout: Layout, weights: torch.Tensor, buf: torch.Tensor, x: torch.Tensor, n: int,
           cond: Optional[torch.Tensor], wavefront: bool) -> torch.Tensor:
    from ...models.wavenet import FILM_SITES

    T, B = layout.T, layout.B
    TB = T * B
    site = {s: i for i, s in enumerate(FILM_SITES)}

    def mat(off: int, rows: int, cols: int) -> torch.Tensor:
        return weights[off : off + rows * cols].view(rows, cols)

    def vec(off: int, rows: int) -> torch.Tensor:
        return weights[off : off + rows][:, None, None]

    def prod(w_io: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(in, out) weights times v (in, frames, B) -> (out, frames, B)."""
        return torch.matmul(w_io.t(), v.reshape(w_io.shape[0], -1)).view(w_io.shape[1], *v.shape[1:])

    def taps(K: int, d: int, M: int, ring: Optional[torch.Tensor], v: torch.Tensor, t0: int = 0,
             t1: int = T) -> torch.Tensor:
        """The K tap windows of v's stream for frames [t0, t1), stacked on
        channels; the history [-mmax T, 0) comes from the ring's mmax past
        blocks."""
        mmax = -(-(K - 1) * d // T)
        past = [ring[(n - m) % M] for m in range(mmax, 0, -1)] if M else []
        hist = torch.cat(past + [v], dim=1)
        return torch.cat([hist[:, mmax * T + t0 - (K - 1 - k) * d : mmax * T + t1 - (K - 1 - k) * d]
                          for k in range(K)], dim=0)

    def ring_view(off: int, M: int, rows: int) -> torch.Tensor:
        return buf[off : off + M * rows * TB].view(M, rows, T, B)

    def film(off: int, shift: bool, W: int, S: int, v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """v * (Wsc . c + bsc) [+ (Wsh . c + bsh)], on v's rows (NAM/film.h)."""
        r = v.shape[0]
        sc = (prod(mat(off, S, W), c) + vec(off + S * W, W))[:r]
        if not shift:
            return v * sc
        sh = (prod(mat(off + S * W + W, S, W), c) + vec(off + 2 * S * W + W, W))[:r]
        return v * sc + sh

    def tail(tc: TailLayout, v: torch.Tensor) -> torch.Tensor:
        if tc.act >= 0:
            v = _act_plain(tc.act, weights[tc.prm : tc.prm + layout.tail_prm], v)
        v = v[: tc.cin]
        ring = ring_view(tc.ring, tc.M, tc.cin) if tc.M else None
        y = prod(mat(tc.w, tc.K * tc.cin, tc.cout), taps(tc.K, tc.d, tc.M, ring, v))
        if tc.b >= 0:
            y = y + vec(tc.b, tc.cout)
        if tc.M:
            ring[n % tc.M].copy_(v)
        return y

    def layer(a: ArrayLayout, lp: LayerLayout, S: int, src: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              t0: int, t1: int):
        """Layer lp on frames [t0, t1): src (C, T, B) is this block's layer
        input as the taps read it (the past frames come from the ring), h the
        residual and c the condition on those frames. Returns the next
        layer's input, the head accumulator's increment and what the ring
        keeps, all on those frames."""
        C, CP, H = a.C, a.CP, a.CP // 2
        o, s = lp.offs, lp.seg

        def f(name: str, v: torch.Tensor, W: int = CP) -> torch.Tensor:
            return film(s + o[name], lp.shifts[site[name]], W, S, v, c) if name in o else v

        ring = ring_view(lp.ring, lp.M, C) if lp.M else None
        z = prod(mat(s, lp.K * C, CP), taps(lp.K, lp.d, lp.M, ring, src, t0, t1)) + vec(s + o["b"], CP)
        z = f("conv_post_film", z)
        mi = f("input_mixin_pre_film", c, layout.sw)
        z = z + f("input_mixin_post_film", prod(mat(s + o["mix"], S, CP), mi))
        z = f("activation_pre_film", z)
        pw = _prm_width(CP)
        prm1, prm2 = weights[s + o["prm1"] : s + o["prm1"] + pw], weights[s + o["prm2"] : s + o["prm2"] + pw]
        if lp.gating == GATING_CODES["none"]:
            av = _act_plain(lp.act1, prm1, z)
        else:
            top, g = _act_plain(lp.act1, prm1, z[:H]), _act_plain(lp.act2, prm2, z[H:])
            av = top * g if lp.gating == GATING_CODES["gated"] else g * top + (1.0 - g) * z[:H]
            av = torch.cat([av, torch.zeros_like(av)])
        av = f("activation_post_film", av)
        if "l1" in o:
            l1 = prod(mat(s + o["l1"], CP, CP), av) + vec(s + o["l1b"], CP)
            if lp.gating == GATING_CODES["blended"]:  # reference quirk (model.cpp:262-270)
                l1 = f("layer1x1_post_film", l1)
            h = h + l1[:C]
        hd = av
        if "h1" in o:
            hd = f("head1x1_post_film", prod(mat(s + o["h1"], CP, CP), av) + vec(s + o["h1b"], CP))
        return h, hd[: a.HI], src[:, t0:t1]

    def unpacked_array(a: ArrayLayout, S: int, h: torch.Tensor, hacc: Optional[torch.Tensor]):
        for lp in a.layers:
            src = h
            if "conv_pre_film" in lp.offs:  # the conv and its history see the filmed input
                src = film(lp.seg + lp.offs["conv_pre_film"], lp.shifts[site["conv_pre_film"]], a.CP, S, h, c_all)
            h, hd, keep = layer(a, lp, S, src, h, c_all, 0, T)
            if lp.M:
                ring_view(lp.ring, lp.M, a.C)[n % lp.M].copy_(keep)
            hacc = hd if hacc is None else hacc + hd
        return h, hacc

    def wavefront_array(ai: int, a: ArrayLayout, S: int, h: torch.Tensor, hacc: Optional[torch.Tensor]):
        Tg = T // WF_G
        slots = torch.zeros((WF_D, a.C, T, B), device=h.device)
        slots[0] = h  # the rechannel's output is layer 0's input
        h = h.clone()
        hacc = torch.zeros((a.HI, T, B), device=h.device) if hacc is None else hacc.clone()
        for micro in layout.wf.micros[ai]:
            done = []
            for tau, li in enumerate(micro):
                if li >= 0:
                    t0, t1 = tau * Tg, (tau + 1) * Tg
                    lp = a.layers[li]
                    hn, hd, keep = layer(a, lp, S, slots[li % WF_D], h[:, t0:t1], c_all[:, t0:t1], t0, t1)
                    done.append((li, lp, t0, t1, hn, hd, keep.clone()))
            for li, lp, t0, t1, hn, hd, keep in done:  # every pair has read: now the writes
                if lp.M:
                    ring_view(lp.ring, lp.M, a.C)[n % lp.M][:, t0:t1] = keep
                h[:, t0:t1] = hn
                hacc[:, t0:t1] += hd
                slots[(li + 1) % WF_D][:, t0:t1] = hn
        return h, hacc

    c_all = x if cond is None else cond
    ai = 0
    for net in layout.nets:
        S = net.S
        layer_out, hacc = x, None
        for a in net.arrays:
            h = torch.matmul(mat(a.rech, a.C, a.I), layer_out[: a.I].reshape(a.I, TB)).view(a.C, T, B)
            if wavefront:
                layer_out, hacc = wavefront_array(ai, a, S, h, hacc)
            else:
                layer_out, hacc = unpacked_array(a, S, h, hacc)
            hacc = tail(a.hr, hacc)
            ai += 1
        work = weights[net.head_scale] * hacc
        for tc in net.pheads:
            work = tail(tc, work)
        c_all = work  # a condition net's output is the next net's condition
    return work


# =============================================================================
# The kernel: build, bind, launch
# =============================================================================

def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_stack_step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nam_stack_step.restype = ctypes.c_int


def _bind_wf(lib: ctypes.CDLL) -> None:
    lib.nam_stack_wf_step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.nam_stack_wf_step.restype = ctypes.c_int


def _bind_wide(lib: ctypes.CDLL) -> None:
    lib.nam_stack_wide_step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.nam_stack_wide_step.restype = ctypes.c_int
    lib.nam_stack_wide_ctas_per_sm.argtypes = [ctypes.c_int] * 4
    lib.nam_stack_wide_ctas_per_sm.restype = ctypes.c_int


#: csrc/stack.cu, built by nvcc at first launch (``LIB.build_log``: ptxas's report).
LIB = _build.Library("stack.cu", _bind)
#: csrc/stack_wf.cu, the wavefront path (K1g): its own source, so it builds beside stack.cu.
WF_LIB = _build.Library("stack_wf.cu", _bind_wf)
#: csrc/stack_wide.cu, the wide kernel: its own source, so it builds beside stack.cu.
WIDE_LIB = _build.Library("stack_wide.cu", _bind_wide)


def _check_inputs(layout: Layout, x: torch.Tensor, tensors, plan: torch.Tensor,
                  cond: Optional[torch.Tensor]) -> None:
    T, B = layout.T, layout.B
    for name, t in tensors + ([("cond", cond)] if cond is not None else []):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if plan.device != x.device or plan.dtype != torch.int64:
        raise ValueError("plan must be an int64 tensor on x's device")
    if tuple(x.shape) != (layout.Cin, T, B):
        raise ValueError(f"x shape {tuple(x.shape)} != {(layout.Cin, T, B)}")
    if (cond is None) != (layout.S_ext == 0) or (cond is not None and tuple(cond.shape) != (layout.S_ext, T, B)):
        raise ValueError(f"cond must be {(layout.S_ext, T, B) if layout.S_ext else None}")


def launch(layout: Layout, weights: torch.Tensor, plan: torch.Tensor, buf: torch.Tensor,
           x: torch.Tensor, n: int, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel the layout names (csrc/stack.cu, or csrc/stack_wide.cu
    for a wide layout) on the current stream: x (Cin, T, B) and, with a
    pre-pass, cond (S_ext, T, B) -> y (Cout, T, B)."""
    global launches, wide_launches
    _check_inputs(layout, x, [("x", x), ("weights", weights), ("state", buf)], plan, cond)
    y = torch.empty((layout.Cout, layout.T, layout.B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), cond.data_ptr() if cond is not None else None, y.data_ptr(), buf.data_ptr(),
            weights.data_ptr(), plan.data_ptr(), layout.T, layout.B, n, layout.BS)
    wd = layout.wide
    if wd is None:
        lib = LIB.load()
        LIB.check(lib.nam_stack_step(*args, layout.c_max, layout.smem_bytes, stream), "stack kernel")
    else:
        lib = WIDE_LIB.load()
        err = lib.nam_stack_wide_step(*args, wd.rows, wd.srows, int(wd.film_pre), wd.seg_max, wd.tap_max,
                                      wd.threads, layout.smem_bytes, *wd.tile, stream)
        WIDE_LIB.check(err, "stack wide kernel")
        wide_launches += 1
    launches += 1
    return y


def launch_wf(layout: Layout, weights: torch.Tensor, plan: torch.Tensor, sched: torch.Tensor, buf: torch.Tensor,
              x: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the wavefront kernel (K1g) on the current stream: x (1, T, B)
    -> y (Cout, T, B), on the unpacked kernel's state. It builds or launches,
    or raises: it never falls back to the unpacked kernel."""
    global launches, wf_launches
    if layout.wf is None:
        raise ValueError("this model has no wavefront path (see _wavefront_reason)")
    _check_inputs(layout, x, [("x", x), ("weights", weights), ("state", buf)], plan, None)
    if sched.device != x.device or sched.dtype != torch.int64:
        raise ValueError("sched must be an int64 tensor on x's device")
    lib = WF_LIB.load()
    y = torch.empty((layout.Cout, layout.T, layout.B), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nam_stack_wf_step(
        x.data_ptr(), y.data_ptr(), buf.data_ptr(), weights.data_ptr(), plan.data_ptr(), sched.data_ptr(),
        layout.T, layout.B, n, layout.wf.BS, layout.c_max, layout.wf.smem_bytes, stream,
    )
    WF_LIB.check(err, "stack wavefront kernel")
    launches += 1
    wf_launches += 1
    return y


def step(cfg, T: int, eparams, state, x: torch.Tensor):
    """Block step, engine (C, T, B) convention: x (Cin, T, B) -> (y (Cout, T, B), state').
    A CUDA tensor goes through the kernel, a CPU tensor through its plain
    version; with ``WAVEFRONT`` on, an eligible model takes the wavefront
    path. A pre-pass condition model steps first, through its own backend."""
    layout: Layout = eparams["layout"]
    if act.modes() != layout.modes:
        raise ValueError("fast-tanh / LUT modes changed since the fused engine was built: "
                         f"built under {layout.modes}, now {act.modes()}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused stack step runs on CUDA or CPU tensors, got {x.device}")
    wavefront = WAVEFRONT and layout.wf is not None
    if WAVEFRONT and layout.wf is None and _wavefront_ineligible(cfg, T) is None:
        raise ValueError(f"wavefront path: shared memory > {SMEM_LIMIT} B at T={T}")
    n = state["n"] % layout.wrap
    new_state = {"buf": state["buf"], "n": (n + 1) % layout.wrap}
    cond = None
    if "condition" in eparams:
        sub_step, sub_ep = eparams["condition"]
        cond, new_state["condition"] = sub_step(cfg.condition_config, T, sub_ep, state["condition"], x)
    if x.is_cuda and wavefront:
        y = launch_wf(layout, eparams["weights"], eparams["plan"], eparams["wf_sched"], state["buf"],
                      x.contiguous(), n)
    elif x.is_cuda:
        y = launch(layout, eparams["weights"], eparams["plan"], state["buf"], x.contiguous(), n,
                   None if cond is None else cond.contiguous())
    elif wavefront:
        y = step_plain_wf(layout, eparams["weights"], state["buf"], x, n)
    else:
        y = step_plain(layout, eparams["weights"], state["buf"], x, n, cond)
    return y, new_state


# =============================================================================
# Work counts, for the bound
# =============================================================================


def _history_cols(K: int, d: int, T: int) -> int:
    """Frames of history a conv must move per block at the least: the
    distinct past frames its K taps read, and min(rf, T) frames of new
    history."""
    rf = (K - 1) * d
    past = len({t - (K - 1 - k) * d for k in range(K) for t in range(T)} & set(range(-rf, 0)))
    return past + min(rf, T)


def work(cfg, T: int, batch: int) -> Dict[str, float]:
    """What one block needs at the least: MACs (every product the nets do,
    FiLM's scale and shift included) and the bytes that must move (input,
    pre-pass condition and output once; per conv with history, the past
    frames its taps read and the new history it keeps; weights once)."""
    from ...models.wavenet import FILM_SITES, head_conv_specs, layer_film_spec

    nets, S_ext = _net_configs(cfg, T)
    macs = 0
    state_cols = 0
    n_weights = 0
    for ncfg in nets:
        for ac in ncfg.layer_arrays:
            C, S, bn = ac.channels, ac.condition_size, ac.bottleneck
            macs += ac.input_size * C
            n_weights += ac.input_size * C
            for li in range(ac.num_layers):
                K, d, co = ac.kernel_sizes[li], ac.dilations[li], ac.conv_out_channels(li)
                m = K * C * co + S * co
                if ac.layer1x1_active:
                    m += bn * C
                if ac.head1x1_active:
                    m += bn * ac.head1x1_out_channels
                for site in FILM_SITES:
                    spec = layer_film_spec(ac, li, site)
                    if spec is not None:
                        m += S * spec.cond_spec.out_channels
                        n_weights += spec.cond_spec.out_channels
                macs += m
                n_weights += m + co + (C if ac.layer1x1_active else 0)
                n_weights += ac.head1x1_out_channels if ac.head1x1_active else 0
                state_cols += C * _history_cols(K, d, T)
            K, HI, HS = ac.head_kernel_size, ac.head_output_size, ac.head_size
            macs += K * HI * HS
            n_weights += K * HI * HS + (HS if ac.head_bias else 0)
            state_cols += HI * _history_cols(K, ac.head_dilation, T)
        n_weights += 1  # head_scale
        if ncfg.head is not None:
            for s in head_conv_specs(ncfg.head):
                macs += s.kernel_size * s.in_channels * s.out_channels
                n_weights += s.kernel_size * s.in_channels * s.out_channels + s.out_channels
                state_cols += s.in_channels * _history_cols(s.kernel_size, s.dilation, T)
    per_stream = 4 * (state_cols + (cfg.in_channels + S_ext + cfg.out_channels_) * T)
    return {
        "macs": float(macs * T * batch),
        "flops": float(2 * macs * T * batch),
        "bytes": float(per_stream * batch + 4 * n_weights),
    }
