#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--out report.json]

Phases (any failure raises and exits non-zero):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build every kernel of the main path from the checkout's sources (nvcc,
     sm_90a) and print the build time and ptxas's register / spill report;
  3. each kernel against its plain PyTorch version on the card, same inputs
     from a seed, outputs and state to <= 2e-5 absolute: the flagship at
     B=2048 T=64 over 8 blocks, the flagship at T=16 (deep dilations wrap the
     rings), the offset-splice dilations, and a config that runs every
     activation the kernel has;
  4. the main path end to end: load_model(.nam) on the card, StreamEngine
     with kernel="auto" (must pick "fused"), reset with prewarm, 32 blocks;
     the kernel's launch count must equal prewarm blocks + 32, and the output
     must be finite and within 2e-5 of the torch engine tier on the card;
  5. per-block times with CUDA events after warm-up (kernel, plain version,
     torch engine tier) and the real-time 48 kHz stream count;
  6. a {"kernels": [...]} line, then as the last line
     {"ok": true, "device": {...}}.

The script imports nothing of JAX; it needs a CUDA card and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

ATOL = 2e-5  # tier-against-tier tolerance of the JAX package (tests/test_pallas_stack.py:32)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published
SAMPLE_RATE = 48000.0
SEED = 1234


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


def compare_kernel_with_plain(nam, stack, make_nam, name, config, T, B, n_blocks, seed):
    """Same model, same inputs, state carried: kernel vs plain version."""
    model = nam.load_model(make_nam("WaveNet", config, seed=seed), device="cuda")
    reason = stack.supports(model.config, T, B)
    if reason is not None:
        raise RuntimeError(f"{name}: kernel refuses the config: {reason}")
    ep, sk = stack.prepare(model.config, model.params, T, B)
    layout = ep["layout"]
    buf_plain = sk["buf"].clone()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err_y = err_s = 0.0
    for i in range(n_blocks):
        x = randn((layout.Cin, T, B), gen)
        n = sk["n"]
        yk, sk = stack.step(model.config, T, ep, sk, x)
        yp = stack.step_plain(layout, ep["weights"], buf_plain, x, n % layout.wrap)
        torch.cuda.synchronize()
        err_y = max(err_y, (yk - yp).abs().max().item())
        err_s = max(err_s, (sk["buf"] - buf_plain).abs().max().item())
        if not torch.isfinite(yk).all():
            raise RuntimeError(f"{name}: non-finite kernel output at block {i}")
    log(f"compare {name}: T={T} B={B} blocks={n_blocks} wrap={layout.wrap} "
        f"max|y_kernel-y_plain|={err_y:.3e} max|state_kernel-state_plain|={err_s:.3e}")
    if not (err_y <= ATOL and err_s <= ATOL):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version beyond {ATOL}")
    return max(err_y, err_s)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the full report as JSON here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2

    import neuralampmodelercore_tpu_torch as nam
    from neuralampmodelercore_tpu_torch.ops.cuda import stack
    from neuralampmodelercore_tpu_torch.tools.generate import make_nam, wavenet_preset

    report = {}
    # -- 1. the card ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s))")
    log(smi)  # nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    report["device"] = {"kind": kind, "nvidia_smi": smi}

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = stack.compile_library()
    stack._library()
    build_s = time.perf_counter() - t0
    log(f"build: {stack.SOURCE.name} -> {so.name} ({' '.join(stack.NVCC_FLAGS)}) in {build_s:.1f} s")
    for line in stack.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  ptxas: {line.strip()}")
    report["build_s"] = build_s

    # -- 3. kernel vs plain -----------------------------------------------
    errs = {
        "flagship_T64_B2048": compare_kernel_with_plain(
            nam, stack, make_nam, "flagship T=64", wavenet_preset("standard"), 64, 2048, 8, SEED),
        "flagship_T16_B2048": compare_kernel_with_plain(
            nam, stack, make_nam, "flagship T=16", wavenet_preset("standard"), 16, 2048, 12, SEED + 1),
        "splice_T16_B2048": compare_kernel_with_plain(
            nam, stack, make_nam, "offset splice", splice_config(), 16, 2048, 10, SEED + 2),
        "activations_T32_B1000": compare_kernel_with_plain(
            nam, stack, make_nam, "all activations", activations_config(), 32, 1000, 8, SEED + 3),
    }
    report["max_abs_err"] = errs
    max_err = max(errs.values())

    # -- 4. the main path ---------------------------------------------------
    B, T, n_blocks = 2048, 64, 32
    doc = make_nam("WaveNet", wavenet_preset("standard"), seed=SEED)
    model = nam.load_model(doc)  # on the card by default
    if model.device.type != "cuda":
        raise RuntimeError(f"load_model put the model on {model.device}")
    engine = nam.StreamEngine(model, batch=B, block_size=T)  # kernel="auto"
    log(f"main path: StreamEngine(kernel='auto') chose {engine.kernel!r}")
    if engine.kernel != "fused":
        raise RuntimeError(f"auto chose {engine.kernel!r}, expected 'fused'")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    blocks = [randn((B, T), gen) for _ in range(n_blocks)]

    stack.launches = 0
    state = engine.reset()  # prewarm on
    ys = []
    for x in blocks:
        y, state = engine.process(x, state)
        ys.append(y)
    torch.cuda.synchronize()
    launched = stack.launches
    expect = engine.prewarm_blocks() + n_blocks
    log(f"main path: prewarm {model.get_prewarm_samples()} samples = {engine.prewarm_blocks()} blocks; "
        f"kernel launches {launched}, expected {expect}")
    if launched != expect:
        raise RuntimeError(f"launch count {launched} != {expect}")
    y_fused = torch.stack(ys)
    if tuple(y_fused.shape) != (n_blocks, B, T) or not torch.isfinite(y_fused).all():
        raise RuntimeError(f"main path output shape {tuple(y_fused.shape)} or non-finite values")

    ref = nam.StreamEngine(model, batch=B, block_size=T, kernel="torch")
    rstate = ref.reset()
    yr = []
    for x in blocks:
        y, rstate = ref.process(x, rstate)
        yr.append(y)
    main_err = (y_fused - torch.stack(yr)).abs().max().item()
    log(f"main path: {n_blocks} blocks, |y| max {y_fused.abs().max().item():.3f}, "
        f"max|fused - torch tier| = {main_err:.3e}")
    if not main_err <= ATOL:
        raise RuntimeError(f"main path disagrees with the torch engine tier: {main_err:.3e} > {ATOL}")
    report["main_path"] = {"B": B, "T": T, "blocks": n_blocks, "launches": launched, "max_abs_err_vs_torch_tier": main_err}
    del engine, ref, state, rstate

    # -- 5. timing ----------------------------------------------------------
    deadline_ms = 1e3 * T / SAMPLE_RATE
    cfg = model.config
    times = {}
    for Bt in (1024, 2048, 4096):
        ep, st = stack.prepare(cfg, model.params, T, Bt)
        layout = ep["layout"]
        x = randn((1, T, Bt), gen)
        box = {"s": st}

        def run_kernel():
            _, box["s"] = stack.step(cfg, T, ep, box["s"], x)

        def run_plain():
            stack.step_plain(layout, ep["weights"], box["s"]["buf"], x, 0)

        teng = nam.StreamEngine(model, batch=Bt, block_size=T, kernel="torch")
        tbox = {"s": teng.reset(prewarm=False)}

        def run_torch():
            _, tbox["s"] = teng.step(tbox["s"], x)

        k1 = time_per_block(run_kernel)
        p1 = time_per_block(run_plain, n_iter=5)
        t1 = time_per_block(run_torch, n_iter=5)
        k2 = time_per_block(run_kernel)
        p2 = time_per_block(run_plain, n_iter=5)
        w = stack.work(cfg, T, Bt)
        bound = 1e3 * max(w["bytes"] / HBM_BYTES_PER_S, w["flops"] / F32_FLOPS_PER_S)
        times[Bt] = {
            "kernel_ms": [k1, k2], "plain_ms": [p1, p2], "torch_tier_ms": t1,
            "bound_ms": bound,
            "bound_by": "bytes" if w["bytes"] / HBM_BYTES_PER_S >= w["flops"] / F32_FLOPS_PER_S else "operations",
            "bytes": w["bytes"], "flops": w["flops"],
        }
        log(f"time B={Bt} T={T}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"torch tier {t1:.4f} ms, bound {bound:.4f} ms ({times[Bt]['bound_by']}), "
            f"deadline {deadline_ms:.4f} ms  [{smi}]")
        del ep, st, box, teng, tbox
        torch.cuda.empty_cache()

    # Real-time streams: the largest batch (doubling) whose kernel time per
    # block stays under the T / 48 kHz deadline.
    rt_streams, Bt = 0, 4096
    sweep = {}
    while Bt <= 65536:
        ep, st = stack.prepare(cfg, model.params, T, Bt)
        x = randn((1, T, Bt), gen)
        box = {"s": st}

        def run_kernel():
            _, box["s"] = stack.step(cfg, T, ep, box["s"], x)

        ms = time_per_block(run_kernel, n_iter=10)
        sweep[Bt] = ms
        log(f"sweep B={Bt}: kernel {ms:.4f} ms/block (deadline {deadline_ms:.4f} ms)")
        del ep, st, box
        torch.cuda.empty_cache()
        if ms > deadline_ms:
            break
        rt_streams = Bt
        Bt *= 2
    log(f"real-time 48 kHz streams (kernel, T={T}, doubling sweep): {rt_streams}  [{smi}]")
    report["times"] = times
    report["sweep_ms"] = sweep
    report["realtime_streams"] = rt_streams

    # -- 6. result lines ----------------------------------------------------
    main_t = times[2048]
    kernels = {
        "kernels": [
            {
                "name": "stack_step",
                "route": "cuda",
                "source": "neuralampmodelercore_tpu_torch/csrc/stack.cu",
                "replaces": "neuralampmodelercore_tpu/ops/pallas/stack.py:1769",
                "tpu_counterpart": "neuralampmodelercore_tpu/ops/pallas/stack.py _make_kernel (K1a)",
                "launches": launched,
                "max_abs_err": max_err,
                "ms": min(main_t["kernel_ms"]),
                "kernel_ms": min(main_t["kernel_ms"]),
                "plain_ms": min(main_t["plain_ms"]),
                "bound_ms": main_t["bound_ms"],
                "bound_by": main_t["bound_by"],
                "library_ms": None,
                "shape": {"B": 2048, "T": T},
            }
        ]
    }
    report["kernels"] = kernels["kernels"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
