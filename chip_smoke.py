#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--out report.json]

It drives the port's fourteen main paths, each through load_model(.nam) ->
StreamEngine(kernel="auto") -> its hand-written CUDA kernel: the WaveNet
flagship, the LSTM (2 x 16 at B=2048 and at B=32768, both on lstm_wide.cu's
tile kernel, and at B=65536 on lstm.cu, which serves it once the batch is
that large) and the ConvNet;
two WaveNets on the stack kernel's
features: flagship_cond (the flagship with a WaveNet condition DSP, two nets
in one launch) and flagship_max (gating, blending, bottleneck, head1x1, FiLM
at all 8 sites, the k=16 head conv and a post-stack head at the flagship's
widths); flagship_fast_tanh (the flagship with the global fast-tanh mode on,
K1f) and flagship_wavefront (the flagship on the wavefront-scheduled kernel,
csrc/stack_wf.cu, K1g); on the wide kernels (csrc/stack_wide.cu,
lstm_wide.cu, convnet_wide.cu): large (the reference's LARGE WaveNet, 64
then 32 channels, at full width), medium_gated (2 * 32 conv rows),
flagship_T1024 (the flagship at T=1,024), lstm_48x2 and convnet_64; the
benchmodel entry point with --engine --fast-tanh; and the port's two tools,
the ring-slot prototype (K4, csrc/proto_ring.cu) and the dot-chain
microbenchmark (K5 and K6, csrc/dot_chain.cu), through their entry points.
Phases (any failure raises and exits non-zero):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build every kernel from the checkout's sources (one nvcc per source,
     stack.cu, stack_wf.cu, stack_wide.cu, lstm.cu, lstm_wide.cu, convnet.cu,
     convnet_wide.cu, proto_ring.cu and dot_chain.cu all started together,
     sm_90a) and print each build time and ptxas's register / spill report
     per kernel instance;
  3. each kernel against its plain PyTorch version on the card, same inputs
     from a seed, state carried, outputs and state to <= 2e-5 absolute:
     stack (the flagship at T=64 and T=16, offset-splice dilations, every
     activation; each FiLM site alone at T=16 with conv_pre_film on a
     dilation that wraps its ring, gated with bottleneck != channels,
     blended with head1x1, layer1x1_post_film under blended and under none,
     head1x1_post_film, a k=16 head with bias at T=64 and T=16, a post-stack
     head, a depth-2 WaveNet condition chain, an LSTM condition pre-pass
     (K2 and the stack kernel must each launch once per block), per-channel
     PReLU, flagship_max), lstm, each case on the kernel the wrapper picks
     for its batch, which must be the one the case names (on the tile
     kernel: 1 x 3, 2 x 16 at T=64, T=34 and a ragged B=1000, H=5 with two
     outputs, 2 x 8, fast-tanh mode, 2 x 16 at B=32768 at T=64, T=34 and
     under fast-tanh; on lstm.cu: 1 x 3 at B=32768, 2 x 16 at B=65536 at
     T=64, T=34 and under fast-tanh, 2 x 8 under fast-tanh and H=5 with two
     outputs at a ragged B=66000), convnet (the amp ConvNet
     at T=64 and at T=16 where deep dilations wrap the rings, no batchnorm,
     groups=2, two in/out channels, a non-Tanh activation, dilations that
     are not multiples of T); the wide kernels, each run counted on the wide
     kernel: stack_wide (rows 33, 48 gated and 64, rows 128, gated MEDIUM,
     LARGE, a 40-channel net inside a fused condition chain, the flagship at
     T=600 and T=1,024, 8 input channels with FiLM; LARGE again at each
     register tile, stack.WIDE_TILES), lstm_wide (48 x 2,
     64 x 1 and 8 x 5, each at T=64 with a ragged B and at T=34, the exact
     prewarm's remainder; 8 inputs; each counted on its tile kernel, and
     64 x 8, whose weights do not fit it, on its group kernel),
     convnet_wide (48, 64 and 128 channels, per-channel PReLU, the amp
     ConvNet at T=1,024); the modes (K1f): the
     flagship at T=64 under fast-tanh, at T=16 under a Tanh LUT (-5, 5, 512
     points), gated_bottleneck
     under a Sigmoid LUT, depthwise (SiLU) under a SiLU LUT, the amp ConvNet
     under fast-tanh and under a Tanh LUT; the wavefront kernel (K1g) against
     step_plain_wf on the flagship at T=64, 16 and 20 (sub-tiles of 5 frames)
     and on offset-splice dilations at T=32, and a stream that switches
     WAVEFRONT on and off between blocks against the unpacked plain version;
     K4 at the prototype's shapes for n = 0, 1, 2, 3, 5, 7 (the slots wrap),
     ring carried: exact (0.0) on y and the ring, the ring's storage
     unchanged, the other slots bit-identical, one launch per step; K5 and
     K6 in f32 and bf16 at the tool's shapes and scale (N = 65,536), one
     launch per chain: f32 within 2e-5 x max|output| (K5, 20 steps) or 2e-5
     (K6), bf16 within 2e-2 x max|output|;
  4. each main path end to end at B=2048, T=64 (flagship_T1024: T=1,024;
     lstm_2x16_B32768 and lstm_2x16_B65536: B=32768 and 65536):
     load_model on the card, StreamEngine with kernel="auto" (must pick
     "fused"), reset with prewarm, 32 blocks. Every launch counter is set to
     0 just before the path and read just after; the path's kernel must have
     run exactly prewarm + 32 times and no other kernel at all (the LSTM's
     prewarm is 344 full blocks and one 34-sample remainder step;
     flagship_wavefront's 96 launches must all be the wavefront kernel's,
     large's 160 the wide kernel's, the lstm_wide.cu paths' 377 its tile
     kernel's, lstm_2x16_B65536's 377 lstm.cu's), and the output must be finite and
     within 2e-5 of the torch engine tier on the card (under the same mode);
     then `python -m neuralampmodelercore_tpu_torch.cli.benchmodel` on the
     flagship .nam with --engine --fast-tanh --batch 2048, and the tools'
     entry points `python -m neuralampmodelercore_tpu_torch.tools.
     proto_ring_kernel` and `...tools.microbench_dots`, each as a subprocess
     whose JSON line gives its launch counts (each tool sets its counters to
     0 before its run; none may be 0 after) and, for K4, its exact check;
  5. per-block times with CUDA events after warm-up, printed beside the
     card's name and power limit: the kernel (twice), its plain version, the
     torch engine tier, the bound, and for the LSTM one cuDNN LSTM call plus
     the head product as the library yardstick, timed twice in turns with
     the kernel (kernel, library, ..., library, kernel; each line names the
     kernel the wrapper picked: the register-tile or the wide one, and the
     LSTM tile kernel's S and SPT); the same for
     the fast-tanh
     flagship, the flagship under a Tanh LUT (-5, 5, 512 points), the
     wavefront flagship (B = 1024, 2048, 4096; its plain version is
     step_plain_wf), the amp ConvNet under fast-tanh and the five wide-kernel
     paths (lstm_48x2 with cuDNN's call; on the three stack_wide.cu paths the
     torch engine tier is the yardstick, timed twice in turns with the
     kernel at its iteration count, kernel / tier logged); then a doubling sweep of the kernel
     for the real-time 48 kHz stream count of each model, of the flagship
     paths and of the five wide-kernel paths (at T=1,024 for
     flagship_T1024: its deadline is 21.3 ms); both LSTM sources on 2 x 16
     and 2 x 8 at B=2048, 32768 and 65536, in turns (points of the sweep
     behind the LSTM wrapper's choice, tools/lstm_tiles.py --sources), and
     lstm_wide.cu's group and tile kernels in turns
     on 48 x 2 and 2 x 16 at B=2048; K4 and each
     K5/K6 variant: the kernel (twice, in turns with its plain version), its
     plain version and the library call, against a bound at the variant's
     rate (float32 FMAs, or the bf16 tensor cores);
  6. the agreement sweep (neuralampmodelercore_tpu_torch/tools/agreement.py):
     every kernel config (30) against the torch engine tier, 8 blocks at B=256
     and 512, T=64, within 2e-5 (the mode configs with their mode set around
     them); one JSON per config;
  7. a {"kernels": [...]} line (ten kernels; K5's numbers are the f32
     chain's, K6's f32 at G=4, each variant's under "variants"), then as
     the last line {"ok": true, "device": {...}}.

The script imports nothing of JAX; it needs a CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ATOL = 2e-5  # tier-against-tier tolerance of the JAX package (tests/test_pallas_stack.py:32)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense, published
SAMPLE_RATE = 48000.0
SEED = 1234
B_MAIN, T_MAIN, N_BLOCKS = 2048, 64, 32

LSTM_MAIN = {"input_size": 1, "hidden_size": 16, "num_layers": 2}  # tools/generate.py's LSTM
LSTM_2X8 = {"input_size": 1, "hidden_size": 8, "num_layers": 2}
AMP_CONVNET = {  # tests/test_pallas_convnet.py:63-70 of the JAX package
    "channels": 16, "dilations": [1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
    "batchnorm": True, "activation": "Tanh",
}

# The stack kernel's main paths (the flagship's is keyed by the kernel's name).
STACK_PATHS = ("stack_step", "flagship_cond", "flagship_max", "flagship_fast_tanh", "flagship_wavefront")
# The wide kernels' main paths: path -> (kernel, architecture, config key, sample rate, T, prewarm blocks,
# remainder). Configs are filled in main() (they need the package).
WIDE_PATHS = {
    "large": ("stack_wide_step", "WaveNet", "large", 48000, 64, 128, 0),
    "medium_gated": ("stack_wide_step", "WaveNet", "medium_gated", 48000, 64, 64, 0),
    "flagship_T1024": ("stack_wide_step", "WaveNet", "flagship", 48000, 1024, 4, 0),
    "lstm_48x2": ("lstm_wide_step", "LSTM", "lstm_48x2", 44100, 64, 344, 34),
    "convnet_64": ("convnet_wide_step", "ConvNet", "convnet_64", 48000, 64, 16, 0),
}
LSTM_48X2 = {"input_size": 1, "hidden_size": 48, "num_layers": 2}
CONVNET_64 = dict(AMP_CONVNET, channels=64)
# Stack feature cases against the plain version: (config in tools/agreement.py, T, B, blocks).
STACK_FEATURE_CASES = [(f"film_{site}", 16, 2048, 6) for site in (
    "conv_pre_film", "conv_post_film", "input_mixin_pre_film", "input_mixin_post_film",
    "activation_pre_film", "activation_post_film")] + [
    ("gated_bottleneck", 16, 2048, 6), ("blended_head1x1", 16, 1000, 6), ("layer1x1_post_film_blended", 16, 2048, 6),
    ("layer1x1_post_film_none", 16, 2048, 6), ("head1x1_post_film", 16, 2048, 6), ("head_k16", 64, 2048, 6),
    ("head_k16", 16, 2048, 6), ("post_head", 16, 2048, 6), ("condition_chain_depth2", 16, 2048, 6),
    ("condition_lstm_prepass", 16, 2048, 6), ("prelu_per_channel", 16, 2048, 6), ("flagship_max", 64, 2048, 4),
]

REPLACES = {
    "stack_step": ("neuralampmodelercore_tpu/ops/pallas/stack.py:1769",
                   "neuralampmodelercore_tpu/ops/pallas/stack.py _make_kernel (K1a-K1f)"),
    "stack_wf_step": ("neuralampmodelercore_tpu/ops/pallas/stack.py:1053",
                      "neuralampmodelercore_tpu/ops/pallas/stack.py _make_kernel's wf_array behind WAVEFRONT (K1g)"),
    "lstm_step": ("neuralampmodelercore_tpu/ops/pallas/lstm.py:208",
                  "neuralampmodelercore_tpu/ops/pallas/lstm.py _make_kernel (K2)"),
    "convnet_step": ("neuralampmodelercore_tpu/ops/pallas/convnet.py:458",
                     "neuralampmodelercore_tpu/ops/pallas/convnet.py _make_kernel (K3)"),
    "stack_wide_step": ("neuralampmodelercore_tpu/ops/pallas/stack.py:1769",
                        "neuralampmodelercore_tpu/ops/pallas/stack.py _make_kernel beyond 32 rows, 4 input channels "
                        "or 512 frames (G1, G2, G5)"),
    "lstm_wide_step": ("neuralampmodelercore_tpu/ops/pallas/lstm.py:208",
                       "neuralampmodelercore_tpu/ops/pallas/lstm.py _make_kernel beyond hidden 32, 4 layers or "
                       "4 inputs (G3, G5)"),
    "convnet_wide_step": ("neuralampmodelercore_tpu/ops/pallas/convnet.py:458",
                          "neuralampmodelercore_tpu/ops/pallas/convnet.py _make_kernel beyond 32 channels or 512 "
                          "frames, and per-channel PReLU (G2, G4, G6)"),
    "proto_ring_step": ("tools/proto_ring_kernel.py:57", "tools/proto_ring_kernel.py step -> kernel (K4)"),
    "dot_chain": ("tools/microbench_pallas_dots.py:77",
                  "tools/microbench_pallas_dots.py make_chain.run -> chain_kernel (K5)"),
    "dot_chain_packed": ("tools/microbench_pallas_dots.py:115",
                         "tools/microbench_pallas_dots.py make_packed.run -> packed_kernel (K6)"),
}
# The tools' kernels: entry name -> (source, the variant whose numbers stand at the top of the entry).
TOOL_KERNELS = {"proto_ring_step": ("proto_ring.cu", None), "dot_chain": ("dot_chain.cu", "chain f32"),
                "dot_chain_packed": ("dot_chain.cu", "packed G=4 f32")}
PROTO_NS = (0, 1, 2, 3, 5, 7)  # K4's step counters: the slots wrap at M = 4
# The kernel each wrapper's wide counter counts.
WIDE_OF = {"stack_step": "stack_wide_step", "lstm_step": "lstm_wide_step", "convnet_step": "convnet_wide_step"}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unavailable"


def randn(shape, gen, device="cuda"):
    return torch.randn(shape, generator=gen, device=device) * 0.3


def splice_config():
    """Dilations that are not multiples of T: every deep tap window straddles
    two past blocks (tests/test_pallas_stack.py:69-87 of the JAX package)."""
    return {
        "layers": [
            {
                "input_size": 1, "condition_size": 1, "channels": 8, "head_size": 1,
                "kernel_size": 3, "dilations": [3, 12, 28, 52], "activation": "Tanh",
                "gated": False, "head_bias": True,
            }
        ],
        "head": None,
    }


def activations_config():
    """Every activation the kernel implements, one per layer, with two input
    channels, padded channel counts (6 and 5 -> 8), mixed kernel sizes and a
    second array without layer1x1."""
    acts = [
        "Tanh", "ReLU", "Sigmoid", "Hardtanh", {"type": "LeakyReLU", "negative_slope": 0.2},
        "SiLU", "Softsign", "Hardswish", "Fasttanh",
        {"type": "LeakyHardtanh", "min_val": -0.5, "max_val": 0.7, "min_slope": 0.1, "max_slope": 0.05},
        {"type": "PReLU", "negative_slope": 0.3},
    ]
    return {
        "in_channels": 2,
        "layers": [
            {
                "input_size": 2, "condition_size": 2, "channels": 6, "head_size": 5,
                "kernel_sizes": [2, 3, 4, 3, 2, 3, 3, 1, 3, 2, 3],
                "dilations": [1, 3, 7, 16, 33, 64, 5, 1, 100, 9, 2],
                "activation": acts, "gated": False, "head_bias": False,
            },
            {
                "input_size": 6, "condition_size": 2, "channels": 5, "head_size": 2,
                "kernel_size": 3, "dilations": [2, 40], "activation": "Softsign",
                "layer1x1": {"active": False, "groups": 1}, "gated": False, "head_bias": True,
            },
        ],
        "head": None,
    }


def _check_err(name, err_y, err_s):
    if not (err_y <= ATOL and err_s <= ATOL):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version beyond {ATOL}")
    return max(err_y, err_s)


def compare_ring_kernel(nam, mod, make_nam, arch, name, config, T, B, n_blocks, seed, lstm=None, wavefront=False,
                        wide=False, wide_tile=None):
    """Same model, same inputs, state carried: a kernel with a flat ring-state
    buffer (stack, convnet) vs its plain version. A stack model with an LSTM
    condition pre-pass takes the pre-pass through K2 on the kernel's side and
    through K2's plain version on the plain side; each kernel must launch once
    per block. With ``wavefront`` (and stack.WAVEFRONT on) every block must
    launch the wavefront kernel, held against step_plain_wf. Any global mode
    is the caller's. With ``wide`` every block must launch the wrapper's wide
    kernel, else none may; ``wide_tile`` forces the wide stack kernel's
    register tile (stack.prepare's ``wide_tile``)."""
    model = nam.load_model(make_nam(arch, config, seed=seed), device="cuda")
    reason = mod.supports(model.config, T, B)
    if reason is not None:
        raise RuntimeError(f"{name}: kernel refuses the config: {reason}")
    ep, sk = mod.prepare(model.config, model.params, T, B, **({"wide_tile": wide_tile} if wide_tile else {}))
    layout = ep["layout"]
    if wide_tile and layout.wide.tile != wide_tile:
        raise RuntimeError(f"{name}: tile {layout.wide.tile}, {wide_tile} forced")
    step_plain = mod.step_plain_wf if wavefront else mod.step_plain
    wf_before = mod.wf_launches if wavefront else 0
    wide_before = mod.wide_launches
    buf_plain = sk["buf"].clone()
    cstate = None
    if "condition" in sk:
        sub_step, sub_ep = ep["condition"]
        if lstm is None or sub_step is not lstm.step:
            raise RuntimeError(f"{name}: the condition pre-pass does not run the LSTM kernel")
        cstate = {k: v.clone() for k, v in sk["condition"].items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err_y = err_s = 0.0
    before = (mod.launches, lstm.launches if lstm else 0)
    for i in range(n_blocks):
        x = randn((layout.Cin, T, B), gen)
        n = sk["n"]
        cond = []
        if cstate is not None:
            cond = [lstm.step_plain(sub_ep["layout"], sub_ep["weights"], cstate["h"], cstate["c"], x)]
        yk, sk = mod.step(model.config, T, ep, sk, x)
        yp = step_plain(layout, ep["weights"], buf_plain, x, n % layout.wrap, *cond)
        torch.cuda.synchronize()
        err_y = max(err_y, (yk - yp).abs().max().item())
        err_s = max(err_s, (sk["buf"] - buf_plain).abs().max().item())
        if cstate is not None:
            err_s = max(err_s, *((sk["condition"][k] - cstate[k]).abs().max().item() for k in ("h", "c")))
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{name}: non-finite kernel output at block {i}")
    launched = (mod.launches - before[0], lstm.launches - before[1] if lstm else 0)
    expect = (n_blocks, n_blocks if cstate is not None else 0)
    if launched != expect:
        raise RuntimeError(f"{name}: launches (kernel, K2) {launched}, expected {expect}")
    if wavefront and mod.wf_launches - wf_before != n_blocks:
        raise RuntimeError(f"{name}: {mod.wf_launches - wf_before} wavefront launches, expected {n_blocks}")
    if mod.wide_launches - wide_before != (n_blocks if wide else 0):
        raise RuntimeError(f"{name}: {mod.wide_launches - wide_before} wide-kernel launches, "
                           f"expected {n_blocks if wide else 0}")
    prepass = f" launches stack {launched[0]}, lstm {launched[1]};" if cstate is not None else ""
    if getattr(layout, "wide", None) is not None and hasattr(layout.wide, "tile"):
        prepass += f" tile {layout.wide.tile[0]} x {layout.wide.tile[1]}, {layout.wide.threads} threads, BS {layout.BS};"
    log(f"compare {arch} {name}: T={T} B={B} blocks={n_blocks} wrap={layout.wrap}{prepass} "
        f"max|y_kernel-y_plain|={err_y:.3e} max|state_kernel-state_plain|={err_s:.3e}")
    return _check_err(name, err_y, err_s)


def compare_wavefront_switch(nam, stack, make_nam, config, T, B, n_blocks, seed):
    """One stream whose blocks alternate between the wavefront kernel
    (WAVEFRONT on) and the unpacked kernel, against the unpacked plain
    version: the two kernels keep the same state."""
    model = nam.load_model(make_nam("WaveNet", config, seed=seed), device="cuda")
    ep, sk = stack.prepare(model.config, model.params, T, B)
    layout = ep["layout"]
    buf_plain = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err_y = err_s = 0.0
    before = (stack.launches, stack.wf_launches)
    try:
        for i in range(n_blocks):
            stack.WAVEFRONT = i % 2 == 0
            x = randn((1, T, B), gen)
            n = sk["n"]
            yk, sk = stack.step(model.config, T, ep, sk, x)
            yp = stack.step_plain(layout, ep["weights"], buf_plain, x, n)
            torch.cuda.synchronize()
            err_y = max(err_y, (yk - yp).abs().max().item())
            err_s = max(err_s, (sk["buf"] - buf_plain).abs().max().item())
    finally:
        stack.WAVEFRONT = False
    launched = (stack.launches - before[0], stack.wf_launches - before[1])
    if launched != (n_blocks, (n_blocks + 1) // 2):
        raise RuntimeError(f"wavefront switch: launches (all, wavefront) {launched}")
    log(f"compare WaveNet wavefront on/off between blocks: T={T} B={B} blocks={n_blocks} launches {launched}; "
        f"max|y_kernel-y_plain|={err_y:.3e} max|state_kernel-state_plain|={err_s:.3e}")
    return _check_err("wavefront switch", err_y, err_s)


def compare_lstm(nam, lstm, act, make_nam, name, config, T, B, n_blocks, seed, fast=False):
    """The LSTM kernel the wrapper picks for (config, B) -- lstm.cu, or
    lstm_wide.cu's tile kernel where the model fits its shared memory, else
    its group kernel; the kernel must then run every block -- against its
    plain version, state carried. Returns (the kernel's name, whether it was
    the tile kernel, the error); the caller checks the kernel."""
    model = nam.load_model(make_nam("LSTM", config, seed=seed), device="cuda")
    wide = lstm._is_wide(model.config, B)
    tile = wide and lstm._tile(model.config, B) is not None
    wide_before, tile_before = lstm.wide_launches, lstm.tile_launches
    if fast:
        act.enable_fast_tanh()
    try:
        reason = lstm.supports(model.config, T, B)
        if reason is not None:
            raise RuntimeError(f"{name}: kernel refuses the config: {reason}")
        ep, sk = lstm.prepare(model.config, model.params, T, B)
        hp, cp = sk["h"].clone(), sk["c"].clone()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        err_y = err_s = 0.0
        for i in range(n_blocks):
            x = randn((model.config.in_channels, T, B), gen)
            yk, sk = lstm.step(model.config, T, ep, sk, x)
            yp = lstm.step_plain(ep["layout"], ep["weights"], hp, cp, x)
            torch.cuda.synchronize()
            err_y = max(err_y, (yk - yp).abs().max().item())
            err_s = max(err_s, (sk["h"] - hp).abs().max().item(), (sk["c"] - cp).abs().max().item())
            if not torch.isfinite(yk).all():
                raise RuntimeError(f"{name}: non-finite kernel output at block {i}")
    finally:
        act.disable_fast_tanh()
    launched = (lstm.wide_launches - wide_before, lstm.tile_launches - tile_before)
    if launched != ((n_blocks if wide else 0), (n_blocks if tile else 0)):
        raise RuntimeError(f"{name}: (wide, tile) kernel launches {launched}, expected "
                           f"{(n_blocks if wide else 0, n_blocks if tile else 0)}")
    kernel = "lstm_wide_step" if wide else "lstm_step"
    which = f" tile S={ep['layout'].tile} SPT={ep['layout'].tile_spt}" if tile else " group" if wide else ""
    log(f"compare lstm {name} ({kernel}{which}): T={T} B={B} blocks={n_blocks} "
        f"max|y_kernel-y_plain|={err_y:.3e} max|state_kernel-state_plain|={err_s:.3e}")
    return kernel, tile, _check_err(name, err_y, err_s)


def time_per_block(fn, n_iter=20, n_warm=3):
    """Milliseconds per call from CUDA events around n_iter calls, after warm-up."""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def bound(work, flops_per_s=F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and FLOPs over
    the rate the work runs at (float32 unless stated)."""
    tb, tf = work["bytes"] / HBM_BYTES_PER_S, work["flops"] / flops_per_s
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def kernel_counts(modules):
    """Launches per kernel: each module counts all of its kernels and, apart,
    its wide kernel's (the stack module its wavefront kernel's too)."""
    counts = {}
    for k, m in modules.items():
        counts[WIDE_OF[k]] = m.wide_launches
        counts[k] = m.launches - m.wide_launches
    counts["stack_wf_step"] = modules["stack_step"].wf_launches
    counts["stack_step"] -= counts["stack_wf_step"]
    return counts


def reset_counts(modules):
    for m in modules.values():
        m.launches = m.wide_launches = 0
    modules["stack_step"].wf_launches = 0
    modules["lstm_step"].tile_launches = 0


def run_main_path(nam, modules, name, doc, expect_full, expect_rem, gen, path=None, T=T_MAIN, B=B_MAIN):
    """load_model -> StreamEngine(auto) -> reset with prewarm -> 32 blocks,
    with every launch counter set to 0 just before and read just after; then
    the torch engine tier on the same blocks. ``name`` is the kernel the
    path must run; ``path`` names the path where it is not the kernel's own.
    A global mode or the wavefront flag is the caller's."""
    label = path or name
    model = nam.load_model(doc)  # on the card by default
    if model.device.type != "cuda":
        raise RuntimeError(f"{label}: load_model put the model on {model.device}")
    engine = nam.StreamEngine(model, batch=B, block_size=T)  # kernel="auto"
    log(f"main path {label}: StreamEngine(kernel='auto') chose {engine.kernel!r}")
    if engine.kernel != "fused":
        raise RuntimeError(f"{label}: auto chose {engine.kernel!r}, expected 'fused'")
    full, rem = engine.prewarm_plan()
    if (full, rem) != (expect_full, expect_rem):
        raise RuntimeError(f"{label}: prewarm plan {(full, rem)} != {(expect_full, expect_rem)}")
    blocks = [randn((B, T), gen) for _ in range(N_BLOCKS)]  # mono, (B, T)

    reset_counts(modules)
    state = engine.reset()  # prewarm on
    ys = []
    for x in blocks:
        y, state = engine.process(x, state)
        ys.append(y)
    torch.cuda.synchronize()
    counts = kernel_counts(modules)

    expect = full + (1 if rem else 0) + N_BLOCKS
    launched = counts[name]
    log(f"main path {label}: prewarm {model.get_prewarm_samples()} samples = {full} blocks + {rem}-sample "
        f"remainder; launches {counts}, expected {expect} of {name}")
    if launched != expect or any(v for k, v in counts.items() if k != name):
        raise RuntimeError(f"{label}: launch counts {counts}, expected {expect} of {name} and no other")
    tile_launched = modules["lstm_step"].tile_launches
    if name == "lstm_wide_step" and tile_launched != expect:
        raise RuntimeError(f"{label}: {tile_launched} of its {expect} launches ran lstm_wide.cu's tile kernel")
    y_fused = torch.stack(ys)
    if tuple(y_fused.shape) != (N_BLOCKS, B, T):
        raise RuntimeError(f"{label}: main path output shape {tuple(y_fused.shape)}")
    if not torch.isfinite(y_fused).all():
        raise RuntimeError(f"{label}: non-finite main path output")

    ref = nam.StreamEngine(model, batch=B, block_size=T, kernel="torch")
    rstate = ref.reset()
    yr = []
    for x in blocks:
        y, rstate = ref.process(x, rstate)
        yr.append(y)
    err = (y_fused - torch.stack(yr)).abs().max().item()
    log(f"main path {label}: {N_BLOCKS} blocks, |y| max {y_fused.abs().max().item():.3f}, "
        f"max|fused - torch tier| = {err:.3e}")
    if not err <= ATOL:
        raise RuntimeError(f"{label}: main path disagrees with the torch engine tier: {err:.3e} > {ATOL}")
    del engine, ref, state, rstate
    torch.cuda.empty_cache()
    return model, {"B": B, "T": T, "blocks": N_BLOCKS, "prewarm": [full, rem],
                   "launches": launched, "tile_launches": tile_launched, "max_abs_err_vs_torch_tier": err}


def cudnn_lstm(model, state_h, state_c):
    """The library yardstick for K2: torch.nn.LSTM (cuDNN, TF32 off, gates
    i, f, g, o) with the same weights and per-stream h0, c0, plus the head
    product. Returns fn(x (T, B, I)) -> y (T, B, O). Timed here only."""
    cfg, p = model.config, model.params
    mod = torch.nn.LSTM(cfg.input_size, cfg.hidden_size, cfg.num_layers).cuda()
    with torch.no_grad():
        for li, lp in enumerate(p["layers"]):
            w = lp["w"].t()  # (4H, I+H)
            isz = cfg.input_size if li == 0 else cfg.hidden_size
            getattr(mod, f"weight_ih_l{li}").copy_(w[:, :isz])
            getattr(mod, f"weight_hh_l{li}").copy_(w[:, isz:])
            getattr(mod, f"bias_ih_l{li}").copy_(lp["b"])
            getattr(mod, f"bias_hh_l{li}").zero_()
    mod.flatten_parameters()
    h0 = state_h.permute(0, 2, 1).contiguous()  # (L, B, H)
    c0 = state_c.permute(0, 2, 1).contiguous()
    head_w, head_b = p["head_w"], p["head_b"]

    def run(x_tbi):
        with torch.no_grad():
            out, _ = mod(x_tbi, (h0, c0))
            y = torch.addmm(head_b, out.reshape(-1, cfg.hidden_size), head_w)
            return y.view(x_tbi.shape[0], -1, cfg.out_channels)

    return run


def time_model(nam, mod, name, model, batches, gen, smi, library=None, path=None, plain="step_plain", T=T_MAIN,
               torch_turns=False):
    """Kernel (twice, in turns with the plain version), plain version, torch
    engine tier, bound and, where given, the library call, per batch size.
    A global mode or the wavefront flag is the caller's; ``plain`` names the
    plain version (step_plain_wf for the wavefront path). With
    ``torch_turns`` the torch engine tier is the yardstick: it is timed
    twice, in turns with the kernel at the kernel's iteration count (kernel,
    tier, plain, plain, tier, kernel), and the kernel / tier ratio is
    logged."""
    label = path or name
    cfg = model.config
    times = {}
    for Bt in batches:
        ep, st = mod.prepare(cfg, model.params, T, Bt)
        lay = ep["layout"]
        kernel = "wide" if (getattr(lay, "wide", None) or getattr(lay, "wide_group", 0)
                            or getattr(lay, "wide_threads", 0)) else "register tile"
        if getattr(lay, "tile", 0):
            kernel = f"wide, tile S={lay.tile} SPT={lay.tile_spt}"
        x = randn((model.num_input_channels, T, Bt), gen)
        box = {"s": st}

        def run_kernel():
            _, box["s"] = mod.step(cfg, T, ep, box["s"], x)

        if name.startswith("lstm"):
            hp, cp = st["h"].clone(), st["c"].clone()

            def run_plain():
                mod.step_plain(ep["layout"], ep["weights"], hp, cp, x)
        else:
            buf = st["buf"].clone()

            def run_plain():
                getattr(mod, plain)(ep["layout"], ep["weights"], buf, x, 0)

        teng = nam.StreamEngine(model, batch=Bt, block_size=T, kernel="torch")
        tbox = {"s": teng.reset(prewarm=False)}

        def run_torch():
            _, tbox["s"] = teng.step(tbox["s"], x)

        lib_ms = lib_err = lib = None
        if library is not None:
            # From the initial state; the yardstick copies h0 and c0, so the
            # kernel's in-place update below leaves them alone.
            ep2, st2 = mod.prepare(cfg, model.params, T, Bt)
            lib = library(model, st2["h"], st2["c"])
            x_tbi = x.permute(1, 2, 0).contiguous()
            yk, _ = mod.step(cfg, T, ep2, st2, x)
            lib_err = (lib(x_tbi).permute(2, 0, 1) - yk).abs().max().item()
            del ep2, st2

        def run_library():
            lib(x_tbi)

        # Kernel and library call in turns (kernel, library, ..., library,
        # kernel), at the kernel's iteration count; the plain version twice.
        k1 = time_per_block(run_kernel)
        l1 = time_per_block(run_library) if lib else None
        tier = [time_per_block(run_torch)] if torch_turns else []
        p1 = time_per_block(run_plain, n_iter=3, n_warm=1)
        if not torch_turns:
            tier.append(time_per_block(run_torch, n_iter=3, n_warm=1))
        p2 = time_per_block(run_plain, n_iter=3, n_warm=1)
        if torch_turns:
            tier.append(time_per_block(run_torch))
        l2 = time_per_block(run_library) if lib else None
        k2 = time_per_block(run_kernel)
        if lib:
            lib_ms = [l1, l2]
        del lib
        w = mod.work(cfg, T, Bt)
        b_ms, b_by = bound(w)
        times[Bt] = {
            "kernel": kernel, "kernel_ms": [k1, k2], "plain_ms": [p1, p2], "torch_tier_ms": tier, "library_ms": lib_ms,
            "library_max_abs_diff": lib_err, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": w["bytes"], "flops": w["flops"],
        }
        lib_txt = (f", library {lib_ms[0]:.4f}/{lib_ms[1]:.4f} ms (|lib - kernel| {lib_err:.2e})"
                   if lib_ms is not None else "")
        tier_txt = "/".join(f"{t:.4f}" for t in tier)
        if torch_turns:
            tier_txt += f" (kernel / tier {k1 / tier[0]:.3f}/{k2 / tier[1]:.3f})"
        log(f"time {label} B={Bt} T={T} ({kernel} kernel): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"torch tier {tier_txt} ms{lib_txt}, bound {b_ms:.4f} ms ({b_by})  [{smi}]")
        del ep, st, lay, box, teng, tbox
        torch.cuda.empty_cache()
    return times


def lstm_kernels_ab(lstm, model, model_2x8, model_48x2, gen, smi, batches=(2048, 32768, 65536)):
    """Both LSTM sources on the same model and input, in turns (lstm.cu,
    lstm_wide.cu, lstm_wide.cu, lstm.cu) per batch, on 2 x 16 and 2 x 8:
    points of the sweep behind lstm._is_wide's choice (tools/lstm_tiles.py
    --sources), each with the source the wrapper picks; then lstm_wide.cu's group
    and tile kernels in turns (group, tile, tile, group) on 48 x 2 and 2 x 16
    at B=2048."""
    T, out = T_MAIN, {}
    for name, m in (("lstm_2x16", model), ("lstm_2x8", model_2x8)):
        cfg, out[name] = m.config, {}
        for Bt in batches:
            x = randn((cfg.in_channels, T, Bt), gen)
            times = {}
            for wide in (False, True, True, False):
                ep, st = lstm.prepare(cfg, m.params, T, Bt, wide=wide)
                times.setdefault("lstm_wide_step" if wide else "lstm_step", []).append(
                    time_per_block(lambda: lstm.step(cfg, T, ep, st, x)))
                del ep, st
            out[name][Bt] = {**times, "picked": "lstm_wide_step" if lstm._is_wide(cfg, Bt) else "lstm_step"}
            log(f"lstm kernels {name} B={Bt} T={T}: lstm.cu {times['lstm_step'][0]:.4f}/"
                f"{times['lstm_step'][1]:.4f} ms, lstm_wide.cu {times['lstm_wide_step'][0]:.4f}/"
                f"{times['lstm_wide_step'][1]:.4f} ms; the wrapper picks {out[name][Bt]['picked']}  [{smi}]")
            torch.cuda.empty_cache()
    for name, m in (("lstm_48x2", model_48x2), ("lstm_2x16", model)):
        x = randn((m.config.in_channels, T, B_MAIN), gen)
        times = {}
        for tile in (False, None, None, False):
            ep, st = lstm.prepare(m.config, m.params, T, B_MAIN, wide=True, tile=tile)
            times.setdefault("group" if tile is False else "tile", []).append(
                time_per_block(lambda: lstm.step(m.config, T, ep, st, x)))
            if tile is None:
                lay = ep["layout"]
            del ep, st
        out[f"{name}_group_vs_tile"] = {**times, "tile": [lay.tile, lay.tile_spt]}
        log(f"lstm_wide.cu kernels {name} B={B_MAIN} T={T}: group {times['group'][0]:.4f}/{times['group'][1]:.4f} ms, "
            f"tile (S={lay.tile}, SPT={lay.tile_spt}) {times['tile'][0]:.4f}/{times['tile'][1]:.4f} ms  [{smi}]")
        torch.cuda.empty_cache()
    return out


def realtime_sweep(mod, name, model, start, cap, gen, smi, T=T_MAIN):
    """The largest batch (doubling from ``start``) whose kernel time per block
    stays under the T / 48 kHz deadline."""
    deadline_ms = 1e3 * T / SAMPLE_RATE
    cfg = model.config
    rt, Bt, sweep = 0, start, {}
    while Bt <= cap:
        ep, st = mod.prepare(cfg, model.params, T, Bt)
        x = randn((model.num_input_channels, T, Bt), gen)
        box = {"s": st}

        def run_kernel():
            _, box["s"] = mod.step(cfg, T, ep, box["s"], x)

        ms = time_per_block(run_kernel, n_iter=10)
        sweep[Bt] = ms
        log(f"sweep {name} B={Bt}: kernel {ms:.4f} ms/block (deadline {deadline_ms:.4f} ms)  [{smi}]")
        del ep, st, box, x
        torch.cuda.empty_cache()
        if ms > deadline_ms:
            break
        rt = Bt
        Bt *= 2
    log(f"real-time 48 kHz streams ({name}, T={T}, doubling sweep up to {cap}): {rt}  [{smi}]")
    return rt, sweep


def run_benchmodel(doc) -> dict:
    """The benchmodel entry point on the flagship .nam (written under build/),
    with --engine --fast-tanh --batch 2048, as a user runs it: a subprocess
    of this checkout. Its line is printed; a non-zero exit fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "chip_smoke_flagship.nam")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    cmd = [sys.executable, "-m", "neuralampmodelercore_tpu_torch.cli.benchmodel", path, "--engine", "--fast-tanh",
           "--batch", str(B_MAIN)]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"benchmodel --engine --fast-tanh --batch {B_MAIN}: {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"benchmodel exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return {"cmd": " ".join(cmd[1:]), "line": line}


def compare_proto_ring(prk, seed):
    """K4 against its plain version at the prototype's shapes, ring carried
    over PROTO_NS: exact on y and the ring, the ring written in place, the
    slots other than wslot bit-identical, one launch per step."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ring = torch.randn((prk.M, prk.NT, prk.C, prk.TW), generator=gen, device="cuda")
    ring_plain, storage, err = ring.clone(), ring.data_ptr(), 0.0
    for n in PROTO_NS:
        x = torch.randn((prk.C, prk.NT * prk.TW), generator=gen, device="cuda")
        nt = torch.tensor(n, dtype=torch.int32, device="cuda")
        prev, before = ring.clone(), prk.launches
        y = prk.step(ring, x, nt)
        yp = prk.step_plain(ring_plain, x, nt)
        torch.cuda.synchronize()
        if prk.launches != before + 1 or ring.data_ptr() != storage:
            raise RuntimeError(f"proto_ring n={n}: {prk.launches - before} launches, in place {ring.data_ptr() == storage}")
        if not all(torch.equal(ring[m], prev[m]) for m in range(prk.M) if m != n % prk.M):
            raise RuntimeError(f"proto_ring n={n}: a slot other than wslot changed")
        err = max(err, (y - yp).abs().max().item(), (ring - ring_plain).abs().max().item())
    log(f"compare proto_ring: n = {PROTO_NS}, ring {tuple(ring.shape)}: max|kernel - plain| = {err:.3e} "
        f"(y and ring), in place, other slots untouched, one launch per step")
    if err != 0.0:
        raise RuntimeError(f"proto_ring: kernel differs from its plain version by {err}")
    return err


def compare_dot_chain(mbd, operands):
    """K5 and K6 in every variant against their plain versions at the tool's
    shapes and scale, one launch per chain. f32: 2e-5 x max|output| for the
    20-step chain (its output decays to about 2e-4), 2e-5 for K6 (order 1);
    bf16: 2e-2 x max|output|. For f32 the CUDA runtime's CTAs an SM must be
    the ones microbench_dots.f32_ctas_per_sm computes. Returns the error per
    variant."""
    errs = {}
    for name, key, G, d in mbd.cases():
        x, w = operands[key]
        dtype = mbd.DTYPES[d]
        before = (mbd.chain_launches, mbd.packed_launches)
        if G is None:
            got, want = mbd.chain(x, w, dtype), mbd.chain_plain(x, w, dtype)
        else:
            got, want = mbd.packed(x, w, G, dtype), mbd.packed_plain(x, w, G, dtype)
        torch.cuda.synchronize()
        launched = (mbd.chain_launches - before[0], mbd.packed_launches - before[1])
        if launched != ((1, 0) if G is None else (0, 1)) or got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"dot_chain {name}: launches (chain, packed) {launched}, shape {tuple(got.shape)}")
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        tol = 2e-2 * scale if d == "bf16" else (2e-5 * scale if G is None else 2e-5)
        geometry = ""
        if d == "f32":
            R = w.shape[1]
            ctas, mirror = mbd.ctas_per_sm(R), mbd.f32_ctas_per_sm(R)
            if ctas != mirror:
                raise RuntimeError(f"dot_chain {name}: {ctas} CTAs an SM, the geometry says {mirror}")
            geometry = (f"; {-(-x.shape[1] // mbd.f32_cols(R))} CTAs of {mbd.f32_cols(R)} columns, "
                        f"{mbd.f32_smem_bytes(R)} bytes of shared memory, {ctas} an SM")
        log(f"compare dot_chain {name}: x {tuple(x.shape)}, w {tuple(w.shape)}: max|kernel - plain| = {err:.3e} "
            f"(max|output| {scale:.3e}, tolerance {tol:.3e}){geometry}")
        if not err <= tol:
            raise RuntimeError(f"dot_chain {name}: kernel disagrees with its plain version: {err:.3e} > {tol:.3e}")
        errs[name] = err
    return errs


def run_tool(module) -> dict:
    """A tool's entry point as a user runs it, ``python -m``, in a subprocess
    of this checkout; its last JSON line is returned. A non-zero exit fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", f"neuralampmodelercore_tpu_torch.tools.{module}"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
        if not line.startswith("{"):
            log(f"{module}: {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])


def time_tools(prk, mbd, operands, gen, smi):
    """K4 and every K5/K6 variant: the kernel (twice, in turns with its
    plain version), the plain version and the library call, in ms per call,
    with the bound at the variant's rate."""
    times = {}
    ring = torch.randn((prk.M, prk.NT, prk.C, prk.TW), generator=gen, device="cuda")
    ring_plain, ring_lib = ring.clone(), ring.clone()
    x = torch.randn((prk.C, prk.NT * prk.TW), generator=gen, device="cuda")
    n = torch.tensor(2, dtype=torch.int32, device="cuda")
    runs = {"kernel": lambda: prk.step(ring, x, n), "plain": lambda: prk.step_plain(ring_plain, x, n),
            "library": lambda: prk.step_library(ring_lib, x, n)}
    times["proto_ring_step"] = _time_turns(runs, prk.work(), F32_FLOPS_PER_S, "proto_ring_step", smi)
    for name, key, G, d in mbd.cases():
        x, w = operands[key]
        dtype, wl = mbd.DTYPES[d], w.to(mbd.DTYPES[d])
        if G is None:
            runs = {"kernel": lambda: mbd.chain(x, w, dtype), "plain": lambda: mbd.chain_plain(x, w, dtype)}
        else:
            runs = {"kernel": lambda: mbd.packed(x, w, G, dtype), "plain": lambda: mbd.packed_plain(x, w, G, dtype)}
        runs["library"] = lambda: mbd.chain_library(x, wl, dtype)
        S, R, _ = w.shape
        rate = F32_FLOPS_PER_S if d == "f32" else BF16_TC_FLOPS_PER_S
        times[name] = _time_turns(runs, mbd.work(R, S, x.shape[1], dtype), rate, f"dot_chain {name}", smi)
        times[name]["shape"] = {"R": R, "S": S, "N": x.shape[1], "dtype": d}
    return times


def _time_turns(runs, work, rate, label, smi):
    """Kernel, plain, kernel, plain, then the library call (ms per call)."""
    k1 = time_per_block(runs["kernel"], n_iter=50, n_warm=5)
    p1 = time_per_block(runs["plain"], n_iter=10, n_warm=2)
    k2 = time_per_block(runs["kernel"], n_iter=50, n_warm=5)
    p2 = time_per_block(runs["plain"], n_iter=10, n_warm=2)
    lib_ms = time_per_block(runs["library"], n_iter=20, n_warm=2)
    b_ms, b_by = bound(work, rate)
    log(f"time {label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})  [{smi}]")
    return {"kernel_ms": [k1, k2], "plain_ms": [p1, p2], "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": work["bytes"], "flops": work["flops"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2

    import neuralampmodelercore_tpu_torch as nam
    from neuralampmodelercore_tpu_torch.ops import activations as act
    from neuralampmodelercore_tpu_torch.ops.cuda import convnet, lstm, stack
    from neuralampmodelercore_tpu_torch.tools import agreement
    from neuralampmodelercore_tpu_torch.tools import microbench_dots as mbd
    from neuralampmodelercore_tpu_torch.tools import proto_ring_kernel as prk
    from neuralampmodelercore_tpu_torch.tools.generate import make_nam, wavenet_preset, with_condition_dsp

    modules = {"stack_step": stack, "lstm_step": lstm, "convnet_step": convnet}
    libs = {"stack_step": stack.LIB, "stack_wf_step": stack.WF_LIB, "lstm_step": lstm.LIB, "convnet_step": convnet.LIB,
            "stack_wide_step": stack.WIDE_LIB, "lstm_wide_step": lstm.WIDE_LIB, "convnet_wide_step": convnet.WIDE_LIB}
    report = {}
    t_start = time.perf_counter()
    # -- 1. the card ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s))")
    log(smi)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # -- 2. build: one nvcc per source, all started together ---------------
    def build(lib):
        t0 = time.perf_counter()
        so = lib.compile()
        lib.load()
        return so, time.perf_counter() - t0

    all_libs = {**libs, "proto_ring_step": prk.LIB, "dot_chain": mbd.LIB}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(all_libs)) as ex:
        built = dict(zip(all_libs, ex.map(build, all_libs.values())))
    report["build_s"] = {"wall": time.perf_counter() - t0}
    report["ptxas"] = {}
    for name, lib in all_libs.items():
        so, secs = built[name]
        report["build_s"][name] = secs
        log(f"build: {lib.source.name} -> {so.name} in {secs:.1f} s")
        report["ptxas"][name] = [line.strip() for line in lib.build_log.splitlines()
                                 if any(k in line for k in ("Compiling entry", "registers", "spill", "error"))]
        for line in report["ptxas"][name]:
            log(f"  ptxas {lib.source.name}: {line}")
    log(f"build: all {len(all_libs)} libraries in {report['build_s']['wall']:.1f} s (in parallel)")

    # -- 3. kernel vs plain -----------------------------------------------
    features = agreement.configs()  # name -> (architecture, config, seed)
    # (key, name, config, T, B, blocks); the seed is SEED + the case's index.
    ring_cases = {
        "stack_step": ("WaveNet", stack, [
            ("flagship_T64_B2048", "flagship T=64", wavenet_preset("standard"), 64, 2048, 8),
            ("flagship_T16_B2048", "flagship T=16", wavenet_preset("standard"), 16, 2048, 12),
            ("splice_T16_B2048", "offset splice", splice_config(), 16, 2048, 10),
            ("activations_T32_B1000", "all activations", activations_config(), 32, 1000, 8),
        ] + [
            (f"{name}_T{T}_B{B}", name, features[name][1], T, B, n) for name, T, B, n in STACK_FEATURE_CASES
        ]),
        "convnet_step": ("ConvNet", convnet, [
            ("amp_T64_B2048", "amp T=64", AMP_CONVNET, 64, 2048, 12),
            ("amp_T16_B1024", "amp T=16 (ring wrap)", AMP_CONVNET, 16, 1024, 40),
            ("no_bn_bias_relu_T64_B1000", "no batchnorm, bias, ReLU",
             {"channels": 8, "dilations": [1, 2, 4, 8, 128], "batchnorm": False, "activation": "ReLU"},
             64, 1000, 8),
            ("groups2_io2_silu_T16_B777", "groups=2, 2 in / 2 out, SiLU",
             {"channels": 8, "dilations": [1, 2, 4, 32], "batchnorm": True, "activation": "SiLU",
              "groups": 2, "in_channels": 2, "out_channels": 2}, 16, 777, 10),
            ("dilation_not_multiple_T16_B512", "dilations 3, 24, 50 at T=16, LeakyHardtanh",
             {"channels": 6, "dilations": [3, 24, 50], "batchnorm": True,
              "activation": {"type": "LeakyHardtanh", "min_val": -0.5, "max_val": 0.7}}, 16, 512, 12),
        ]),
    }
    lstm_1x3 = {"input_size": 1, "hidden_size": 3, "num_layers": 1}
    lstm_2x5_out2 = {"input_size": 1, "hidden_size": 5, "num_layers": 2, "out_channels": 2}
    lstm_cases = [  # (key, name, config, T, B, blocks, fast-tanh mode, the kernel the wrapper must pick)
        ("1x3_T64_B2048", "1 x 3", lstm_1x3, 64, 2048, 6, False, "lstm_wide_step"),
        ("2x16_T64_B2048", "2 x 16", LSTM_MAIN, 64, 2048, 6, False, "lstm_wide_step"),
        ("2x16_T34_B2048", "2 x 16 T=34", LSTM_MAIN, 34, 2048, 6, False, "lstm_wide_step"),
        ("2x16_T64_B1000", "2 x 16 ragged", LSTM_MAIN, 64, 1000, 6, False, "lstm_wide_step"),
        ("2x5_out2_T64_B1000", "2 x 5, 2 outputs", lstm_2x5_out2, 64, 1000, 6, False, "lstm_wide_step"),
        ("2x16_fast_tanh_T64_B2048", "2 x 16 fast-tanh", LSTM_MAIN, 64, 2048, 6, True, "lstm_wide_step"),
        ("2x8_T64_B2048", "2 x 8", LSTM_2X8, 64, 2048, 6, False, "lstm_wide_step"),
        ("2x16_T64_B32768", "2 x 16 B=32768", LSTM_MAIN, 64, 32768, 4, False, "lstm_wide_step"),
        ("2x16_T34_B32768", "2 x 16 T=34 B=32768", LSTM_MAIN, 34, 32768, 4, False, "lstm_wide_step"),
        ("2x16_fast_tanh_T64_B32768", "2 x 16 fast-tanh B=32768", LSTM_MAIN, 64, 32768, 4, True, "lstm_wide_step"),
        # Where lstm.cu serves: batches of several waves of its CTAs (LSTM_CU_FROM).
        ("1x3_T64_B32768", "1 x 3 B=32768", lstm_1x3, 64, 32768, 4, False, "lstm_step"),
        ("2x16_T64_B65536", "2 x 16 B=65536", LSTM_MAIN, 64, 65536, 4, False, "lstm_step"),
        ("2x16_T34_B65536", "2 x 16 T=34 B=65536", LSTM_MAIN, 34, 65536, 4, False, "lstm_step"),
        ("2x16_fast_tanh_T64_B65536", "2 x 16 fast-tanh B=65536", LSTM_MAIN, 64, 65536, 4, True, "lstm_step"),
        ("2x8_fast_tanh_T64_B65536", "2 x 8 fast-tanh B=65536", LSTM_2X8, 64, 65536, 4, True, "lstm_step"),
        ("2x5_out2_T64_B66000", "2 x 5, 2 outputs, ragged B=66000", lstm_2x5_out2, 64, 66000, 4, False,
         "lstm_step"),
    ]
    # The modes inside the stack kernel and K3 (K1f): (kernel, key, name, config, T, B, blocks, fast-tanh, LUTs).
    mode_cases = [
        ("stack_step", "flagship_fast_tanh_T64_B2048", "flagship T=64 fast-tanh", wavenet_preset("standard"),
         64, 2048, 8, True, ()),
        ("stack_step", "flagship_tanh_lut_T16_B2048", "flagship T=16 Tanh LUT", wavenet_preset("standard"),
         16, 2048, 12, False, (("Tanh", -5.0, 5.0, 512),)),
        ("stack_step", "gated_bottleneck_sigmoid_lut_T16_B2048", "gated_bottleneck Sigmoid LUT",
         features["gated_bottleneck"][1], 16, 2048, 6, False, (("Sigmoid", -2.0, 2.0, 17),)),
        ("stack_step", "depthwise_silu_lut_T16_B2048", "depthwise SiLU LUT", features["depthwise"][1],
         16, 2048, 6, False, (("SiLU", -1.5, 1.5, 40),)),
        ("convnet_step", "amp_fast_tanh_T64_B2048", "amp fast-tanh", AMP_CONVNET, 64, 2048, 12, True, ()),
        ("convnet_step", "amp_tanh_lut_T64_B2048", "amp Tanh LUT", AMP_CONVNET, 64, 2048, 12, False,
         (("Tanh", -1.0, 1.0, 20),)),
    ]
    # The wavefront kernel (K1g) against step_plain_wf: (key, name, config, T, B, blocks).
    wf_cases = [
        ("flagship_T64_B2048", "flagship T=64", wavenet_preset("standard"), 64, 2048, 8),
        ("flagship_T16_B2048", "flagship T=16", wavenet_preset("standard"), 16, 2048, 12),
        ("flagship_T20_B2048", "flagship T=20 (sub-tiles of 5)", wavenet_preset("standard"), 20, 2048, 12),
        ("splice_T32_B2048", "offset splice T=32", splice_config(), 32, 2048, 10),
    ]
    # The wide kernels (csrc/*_wide.cu), each case counted on the wide kernel:
    # (kernel, key, name, config, T, B, blocks).
    wide_layer = agreement.small_layer
    wide_ring_cases = [
        ("stack_wide_step", "rows33_T64_B1000", "rows 33",
         {"layers": [wide_layer(channels=33, head_size=1, dilations=[1, 4, 128])], "head": None}, 64, 1000, 6),
        ("stack_wide_step", "rows48_gated_T16_B2048", "rows 48 (gated, bottleneck 24, head1x1)",
         {"layers": [wide_layer(channels=32, bottleneck=24, gated=True, dilations=[1, 8, 100],
                                head1x1={"active": True, "out_channels": 6, "groups": 1})], "head": None}, 16, 2048, 6),
        ("stack_wide_step", "rows64_T64_B2048", "rows 64",
         {"layers": [wide_layer(channels=64, head_size=1, dilations=agreement.DILATIONS + [1024])], "head": None},
         64, 2048, 6),
        ("stack_wide_step", "rows128_T64_B512", "rows 128",
         {"layers": [wide_layer(channels=128, head_size=1, dilations=[1, 2, 4, 64, 512])], "head": None}, 64, 512, 4),
        ("stack_wide_step", "medium_gated_T64_B2048", "gated MEDIUM (2 x 32 rows)", features["medium_gated"][1],
         64, 2048, 4),
        ("stack_wide_step", "large_T64_B2048", "LARGE", features["large"][1], 64, 2048, 4),
        ("stack_wide_step", "wide_condition_chain_T16_B2048", "40-channel net in a fused condition chain",
         with_condition_dsp({"layers": [wide_layer(channels=8, head_size=1)], "head": None},
                            make_nam("WaveNet", {"layers": [wide_layer(channels=40, head_size=1)], "head": None},
                                     seed=3)), 16, 2048, 6),
        ("stack_wide_step", "flagship_T600_B1000", "flagship T=600", wavenet_preset("standard"), 600, 1000, 3),
        ("stack_wide_step", "flagship_T1024_B2048", "flagship T=1024", wavenet_preset("standard"), 1024, 2048, 3),
        ("stack_wide_step", "in8_film_T64_B2048", "8 input channels, FiLM",
         {"in_channels": 8, "layers": [wide_layer(input_size=8, condition_size=8, channels=8, head_size=1,
                                                  conv_post_film=agreement.film(),
                                                  input_mixin_pre_film=agreement.film())], "head": None},
         64, 2048, 6),
        ("convnet_wide_step", "c48_T64_B2048", "48 channels", dict(AMP_CONVNET, channels=48), 64, 2048, 6),
        ("convnet_wide_step", "c64_T64_B1000", "64 channels", CONVNET_64, 64, 1000, 6),
        ("convnet_wide_step", "c128_T64_B512", "128 channels", dict(AMP_CONVNET, channels=128), 64, 512, 4),
        ("convnet_wide_step", "prelu_per_channel_T64_B2048", "per-channel PReLU",
         {"channels": 16, "dilations": [1, 2, 4, 8, 128], "batchnorm": True,
          "activation": {"type": "PReLU", "negative_slopes": [0.1, 0.2, 0.3, 0.4]}}, 64, 2048, 6),
        ("convnet_wide_step", "amp_T1024_B2048", "amp T=1024", AMP_CONVNET, 1024, 2048, 4),
    ]
    wide_lstm_cases = [  # (key, name, config, T, B, blocks, on the tile kernel)
        ("48x2_T64_B1000", "48 x 2 ragged", LSTM_48X2, 64, 1000, 4, True),
        ("48x2_T34_B2048", "48 x 2 T=34", LSTM_48X2, 34, 2048, 4, True),
        ("64x1_T64_B1000", "64 x 1 ragged", {"input_size": 1, "hidden_size": 64, "num_layers": 1}, 64, 1000, 4, True),
        ("64x1_T34_B2048", "64 x 1 T=34", {"input_size": 1, "hidden_size": 64, "num_layers": 1}, 34, 2048, 4, True),
        ("8x5_T64_B1000", "8 x 5 ragged", {"input_size": 1, "hidden_size": 8, "num_layers": 5}, 64, 1000, 4, True),
        ("8x5_T34_B2048", "8 x 5 T=34", {"input_size": 1, "hidden_size": 8, "num_layers": 5}, 34, 2048, 4, True),
        ("in8_12x2_T64_B777", "8 inputs x 12 x 2",
         {"input_size": 8, "in_channels": 8, "hidden_size": 12, "num_layers": 2}, 64, 777, 4, True),
        # 992 KB of weights: beyond the tile kernel's shared memory.
        ("64x8_T64_B512", "64 x 8", {"input_size": 1, "hidden_size": 64, "num_layers": 8}, 64, 512, 3, False),
    ]
    errs = {name: {} for name in libs}
    for kname, (arch, mod, cases) in ring_cases.items():
        for i, (key, name, config, T, B, n) in enumerate(cases):
            errs[kname][key] = compare_ring_kernel(nam, mod, make_nam, arch, name, config, T, B, n, SEED + i, lstm)
    for i, (kname, key, name, config, T, B, n) in enumerate(wide_ring_cases):
        arch, mod = ("ConvNet", convnet) if kname == "convnet_wide_step" else ("WaveNet", stack)
        errs[kname][key] = compare_ring_kernel(nam, mod, make_nam, arch, f"wide {name}", config, T, B, n, SEED + i,
                                               wide=True)
    # Every register tile of stack_wide.cu (its template instances) on LARGE.
    for tile in sorted(stack.WIDE_TILES):
        errs["stack_wide_step"][f"large_tile{tile[0]}x{tile[1]}_T64_B2048"] = compare_ring_kernel(
            nam, stack, make_nam, "WaveNet", f"wide LARGE tile {tile}", features["large"][1], 64, 2048, 3, SEED,
            wide=True, wide_tile=tile)
    for i, (key, name, config, T, B, n, expect_tile) in enumerate(wide_lstm_cases):
        kname, tile, errs_key = compare_lstm(nam, lstm, act, make_nam, f"wide {name}", config, T, B, n, SEED + i)
        if kname != "lstm_wide_step" or tile != expect_tile:
            raise RuntimeError(f"wide {name}: ran {kname} (tile kernel: {tile}, expected {expect_tile})")
        errs[kname][key] = errs_key
    for i, (kname, key, name, config, T, B, n, fast, luts) in enumerate(mode_cases):
        arch, mod = ring_cases[kname][:2]
        with agreement.modes(fast, luts):
            errs[kname][key] = compare_ring_kernel(nam, mod, make_nam, arch, name, config, T, B, n, SEED + i)
    with agreement.modes(wavefront=True):
        for i, (key, name, config, T, B, n) in enumerate(wf_cases):
            errs["stack_wf_step"][key] = compare_ring_kernel(nam, stack, make_nam, "WaveNet", f"wavefront {name}",
                                                             config, T, B, n, SEED + i, wavefront=True)
    errs["stack_wf_step"]["switch_T64_B2048"] = compare_wavefront_switch(
        nam, stack, make_nam, wavenet_preset("standard"), 64, 2048, 8, SEED)
    for i, (key, name, config, T, B, n, fast, expect) in enumerate(lstm_cases):
        kname, _, err = compare_lstm(nam, lstm, act, make_nam, name, config, T, B, n, SEED + i, fast)
        if kname != expect:
            raise RuntimeError(f"{name}: the wrapper picked {kname}, the case is for {expect}")
        errs[kname][key] = err
    # The tools' kernels (K4-K6) at their tools' shapes.
    errs["proto_ring_step"] = {"n_0_1_2_3_5_7": compare_proto_ring(prk, SEED)}
    dot_operands = {k: (torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()) for k, (x, w) in mbd.data().items()}
    errs["dot_chain"] = compare_dot_chain(mbd, dot_operands)
    report["max_abs_err"] = errs

    # -- 4. the main paths ----------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_models, main = {}, {}
    main_models["stack_step"], main["stack_step"] = run_main_path(
        nam, modules, "stack_step", make_nam("WaveNet", wavenet_preset("standard"), seed=SEED), 64, 0, gen)
    # 0.5 s at 44.1 kHz = 22,050 samples = 344 blocks of 64 and a 34-sample remainder.
    # 2 x 16 runs lstm_wide.cu's tile kernel up to B=32768; lstm.cu serves it from B=65536 on.
    main_models["lstm_2x16"], main["lstm_2x16"] = run_main_path(
        nam, modules, "lstm_wide_step", make_nam("LSTM", LSTM_MAIN, seed=SEED, sample_rate=44100), 344, 34, gen,
        "lstm_2x16")
    main_models["lstm_2x16_B32768"], main["lstm_2x16_B32768"] = run_main_path(
        nam, modules, "lstm_wide_step", make_nam("LSTM", LSTM_MAIN, seed=SEED, sample_rate=44100), 344, 34, gen,
        "lstm_2x16_B32768", B=32768)
    main_models["lstm_2x16_B65536"], main["lstm_2x16_B65536"] = run_main_path(
        nam, modules, "lstm_step", make_nam("LSTM", LSTM_MAIN, seed=SEED, sample_rate=44100), 344, 34, gen,
        "lstm_2x16_B65536", B=65536)
    main_models["convnet_step"], main["convnet_step"] = run_main_path(
        nam, modules, "convnet_step", make_nam("ConvNet", AMP_CONVNET, seed=SEED), 16, 0, gen)
    # The stack kernel's feature paths: prewarm 5,115 and 4,113 samples.
    for path, blocks in (("flagship_cond", 80), ("flagship_max", 65)):
        main_models[path], main[path] = run_main_path(
            nam, modules, "stack_step", make_nam("WaveNet", features[path][1], seed=SEED), blocks, 0, gen, path)
    # The flagship with fast-tanh on before load_model (K1f), and on the wavefront kernel (K1g).
    for path, kernel in (("flagship_fast_tanh", "stack_step"), ("flagship_wavefront", "stack_wf_step")):
        with agreement.mode(path):
            main_models[path], main[path] = run_main_path(
                nam, modules, kernel, make_nam("WaveNet", wavenet_preset("standard"), seed=SEED), 64, 0, gen, path)
    # The wide kernels' paths: the LARGE WaveNet at full width first.
    wide_configs = {"large": features["large"][1], "medium_gated": features["medium_gated"][1],
                    "flagship": wavenet_preset("standard"), "lstm_48x2": LSTM_48X2, "convnet_64": CONVNET_64}
    for path, (kernel, arch, key, rate, T, full, rem) in WIDE_PATHS.items():
        main_models[path], main[path] = run_main_path(
            nam, modules, kernel, make_nam(arch, wide_configs[key], seed=SEED, sample_rate=rate), full, rem, gen,
            path, T=T)
    report["main_path"] = main
    torch.cuda.empty_cache()
    report["benchmodel"] = run_benchmodel(make_nam("WaveNet", wavenet_preset("standard"), seed=SEED))
    # The tools' entry points: each sets its counters to 0, runs, and reports them.
    tools = {"proto_ring_kernel": run_tool("proto_ring_kernel"), "microbench_dots": run_tool("microbench_dots")}
    ring_run = tools["proto_ring_kernel"]
    if ring_run["launches"] != 1 or ring_run["err_y"] != 0.0 or ring_run["err_ring"] != 0.0:
        raise RuntimeError(f"proto_ring_kernel entry point: {ring_run}")
    dot_runs = tools["microbench_dots"]["runs"]
    if sorted(dot_runs) != sorted(c[0] for c in mbd.cases()) or not all(r["launches"] > 0 for r in dot_runs.values()):
        raise RuntimeError(f"microbench_dots entry point: runs {sorted(dot_runs)}, "
                           f"launches {[r['launches'] for r in dot_runs.values()]}")
    log(f"tools: proto_ring_kernel {ring_run['launches']} launch, exact; microbench_dots launches "
        f"{tools['microbench_dots']['launches']} over {len(dot_runs)} runs")
    report["tools"] = tools

    # -- 5. timing ------------------------------------------------------------
    report["times"] = {
        "stack_step": time_model(nam, stack, "stack_step", main_models["stack_step"], (1024, 2048, 4096), gen, smi),
        "lstm_2x16": time_model(nam, lstm, "lstm_step", main_models["lstm_2x16"], (2048, 8192, 32768, 65536), gen,
                                smi, library=cudnn_lstm, path="lstm_2x16"),
        "convnet_step": time_model(nam, convnet, "convnet_step", main_models["convnet_step"], (2048, 8192, 32768),
                                   gen, smi),
        **{path: time_model(nam, stack, "stack_step", main_models[path], (2048,), gen, smi, path=path)
           for path in ("flagship_cond", "flagship_max")},
    }
    with agreement.mode("flagship_fast_tanh"):
        report["times"]["flagship_fast_tanh"] = time_model(nam, stack, "stack_step", main_models["flagship_fast_tanh"],
                                                           (2048,), gen, smi, path="flagship_fast_tanh")
        report["times"]["convnet_fast_tanh"] = time_model(nam, convnet, "convnet_step", main_models["convnet_step"],
                                                          (2048,), gen, smi, path="convnet_fast_tanh")
    with agreement.mode("flagship_lut"):
        report["times"]["flagship_lut"] = time_model(nam, stack, "stack_step", main_models["stack_step"], (2048,), gen,
                                                     smi, path="flagship_lut")
    with agreement.mode("flagship_wavefront"):
        report["times"]["flagship_wavefront"] = time_model(
            nam, stack, "stack_wf_step", main_models["flagship_wavefront"], (1024, 2048, 4096), gen, smi,
            path="flagship_wavefront", plain="step_plain_wf")
    model_2x8 = nam.load_model(make_nam("LSTM", LSTM_2X8, seed=SEED, sample_rate=44100))
    report["lstm_kernels"] = lstm_kernels_ab(lstm, main_models["lstm_2x16"], model_2x8, main_models["lstm_48x2"],
                                             gen, smi)
    report["tool_times"] = time_tools(prk, mbd, dot_operands, gen, smi)
    # The 2 x 16 timings at B=32768 and 65536 are those paths' own.
    for Bt in (32768, 65536):
        report["times"][f"lstm_2x16_B{Bt}"] = {Bt: report["times"]["lstm_2x16"][Bt]}
    for path, (kernel, arch, key, rate, T, full, rem) in WIDE_PATHS.items():
        mod = modules[kernel.replace("_wide", "")]
        report["times"][path] = time_model(nam, mod, kernel, main_models[path], (B_MAIN,), gen, smi, path=path, T=T,
                                           library=cudnn_lstm if arch == "LSTM" else None,
                                           torch_turns=kernel == "stack_wide_step")
    report["realtime_streams"], report["sweep_ms"] = {}, {}
    for path, mod, start, cap in (("stack_step", stack, 4096, 65536), ("lstm_2x16", lstm, 8192, 1 << 20),
                                  ("convnet_step", convnet, 8192, 1 << 18), ("flagship_cond", stack, 1024, 65536),
                                  ("flagship_max", stack, 1024, 65536), ("flagship_fast_tanh", stack, 2048, 65536),
                                  ("flagship_wavefront", stack, 2048, 65536)):
        with agreement.mode(path):
            report["realtime_streams"][path], report["sweep_ms"][path] = realtime_sweep(
                mod, path, main_models[path], start, cap, gen, smi)
    # Capped where a larger batch's state would not fit the card's memory
    # (2.1 MB of state a stream for LARGE at T=64 and for the flagship at
    # T=1,024, 0.6 MB for medium_gated and convnet_64).
    for path, start, cap in (("large", 64, 8192), ("medium_gated", 256, 32768), ("flagship_T1024", 1024, 16384),
                             ("lstm_48x2", 1024, 1 << 20), ("convnet_64", 256, 16384)):
        mod = modules[WIDE_PATHS[path][0].replace("_wide", "")]
        report["realtime_streams"][path], report["sweep_ms"][path] = realtime_sweep(
            mod, path, main_models[path], start, cap, gen, smi, T=WIDE_PATHS[path][4])

    # -- 6. agreement sweep: every kernel config against the torch tier -------
    agree_dir = os.path.join(os.path.dirname(args.out) or ".", "agreement") if args.out else "build/agreement"
    report["agreement"] = agreement.sweep(out=agree_dir, log=log)
    bad = [k for k, r in report["agreement"].items() if not r["ok"]]
    log(f"agreement: {len(report['agreement']) - len(bad)}/{len(report['agreement'])} configs within {ATOL} "
        f"(8 blocks, B=256 and 512, T=64; JSON per config in {agree_dir})")
    if bad:
        raise RuntimeError(f"agreement sweep: {bad} disagree with the torch engine tier beyond {ATOL}")

    # -- 7. result lines ------------------------------------------------------
    def numbers(path):
        t = report["times"][path][main[path]["B"]]
        return {"launches": main[path]["launches"], "ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": min(t["library_ms"]) if t["library_ms"] else None}

    # A kernel's numbers are those of its own main path: the wavefront kernel's
    # the flagship on it, each wide kernel's its first path in WIDE_PATHS.
    # lstm.cu serves 2 x 16 at B=65536, lstm_wide.cu at B=2048.
    own_path = {"stack_wf_step": "flagship_wavefront", "lstm_step": "lstm_2x16_B65536", "lstm_wide_step": "lstm_2x16"}
    for path, (kernel, *_) in WIDE_PATHS.items():
        own_path.setdefault(kernel, path)
    kernels = []
    for name, lib in libs.items():
        replaces, counterpart = REPLACES[name]
        path = own_path.get(name, name)
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"neuralampmodelercore_tpu_torch/csrc/{lib.source.name}",
            "replaces": replaces,
            "tpu_counterpart": counterpart,
            **numbers(path),
            "max_abs_err": max(errs[name].values()),
            "shape": {"B": main[path]["B"], "T": main[path]["T"]},
        }
        entry["kernel_ms"] = entry["ms"]
        if name == "stack_step":
            # The entry's numbers are the flagship path's; each path's own under "paths".
            entry["paths"] = {path: numbers(path) for path in STACK_PATHS}
        elif name == "stack_wide_step":
            entry["paths"] = {path: numbers(path) for path, (k, *_) in WIDE_PATHS.items() if k == name}
        elif name == "lstm_wide_step":
            # Its paths run its tile kernel: every launch is counted there too.
            entry["paths"] = {path: {**numbers(path), "tile_launches": main[path]["tile_launches"]}
                              for path in ("lstm_2x16", "lstm_2x16_B32768", "lstm_48x2")}
        kernels.append(entry)
    # The tools' kernels: launches from their entry points' runs, the rest from phases 3 and 5.
    variant_names = {"dot_chain": [c[0] for c in mbd.cases() if c[2] is None],
                     "dot_chain_packed": [c[0] for c in mbd.cases() if c[2] is not None]}

    def tool_numbers(variant, launched, err):
        t = report["tool_times"][variant]
        return {"launches": launched, "ms": min(t["kernel_ms"]), "plain_ms": min(t["plain_ms"]),
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "max_abs_err": err}

    for name, (source, top) in TOOL_KERNELS.items():
        replaces, counterpart = REPLACES[name]
        entry = {"name": name, "route": "cuda", "source": f"neuralampmodelercore_tpu_torch/csrc/{source}",
                 "replaces": replaces, "tpu_counterpart": counterpart}
        if top is None:
            entry.update(tool_numbers("proto_ring_step", ring_run["launches"], errs[name]["n_0_1_2_3_5_7"]))
            entry["shape"] = {"ring": [prk.M, prk.NT, prk.C, prk.TW], "x": [prk.C, prk.NT * prk.TW]}
        else:
            variants = {v: {**tool_numbers(v, dot_runs[v]["launches"], errs["dot_chain"][v]),
                            "tool_us": dot_runs[v]["us"], "shape": report["tool_times"][v]["shape"]}
                        for v in variant_names[name]}
            entry.update({k: v for k, v in variants[top].items() if k not in ("tool_us",)})
            entry["variant"] = top
            entry["variants"] = variants
        entry["kernel_ms"] = entry["ms"]
        kernels.append(entry)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke: {report['seconds']:.1f} s  [{smi}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
