"""The dot-chain microbenchmark (K5, K6): one hand-written CUDA kernel for
the whole chain, its plain version, and the sweep on the card.

    python -m neuralampmodelercore_tpu_torch.tools.microbench_dots

The counterpart of the JAX package's ``tools/microbench_pallas_dots.py``:
``chain`` replaces ``chain_kernel`` (its ``make_chain.run`` reaches
``pl.pallas_call`` at :77, K5 in ROADMAP.md), ``packed`` replaces
``packed_kernel`` (``make_packed.run``, :115, K6). Both compute S steps of

    y = tanh(w_s . x),   x <- [y; y; y]

with w_s (R, 3R) and x (3R, N): K5 at R = C = 16 and S = L = 20; K6 at
R = 16 G and S = L // G (the tool's packed weights are dense, so G = 8 runs
2 steps, 16 layers). One launch runs the whole chain with the operand kept
on the SM (``csrc/dot_chain.cu``; its header says what bounds it and how).

Variants, by ``dtype``:
  - ``torch.float32``: exact float32, no TF32. It stands for both of the
    tool's f32 variants, ``f32_default`` and ``f32_highest``: on the TPU they
    differ in the number of MXU passes, on the H100 the only exact float32
    product is the one without the tensor cores.
  - ``torch.bfloat16``: weights and each step's operand rounded to bf16,
    products summed in float32 on the tensor cores, tanh and the output in
    float32. A labelled measurement of this tool only; no serving path
    runs it.
The tool's tile width W is the TPU grid's stream tile and does not change
the function, so it is not a knob here.

``chain`` and ``packed`` launch the kernel on CUDA tensors (or raise) and run
the plain version on CPU tensors; ``chain_launches`` and ``packed_launches``
count each wrapper's launches and nothing else. ``f32_cols``,
``f32_smem_bytes`` and ``f32_ctas_per_sm`` mirror the f32 kernels' launch
geometry; ``ctas_per_sm`` asks the CUDA runtime (chip_smoke and the card
tests hold the two equal). ``main`` runs the tool's
sweep at its own sizes and seed on the card (it raises without one) and ends
with a JSON line.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict

import numpy as np
import torch

from ..ops.cuda import _build
from ..utils.profiling import card_and_power_limit

C, K, T, B, L = 16, 3, 64, 1024, 20  # the tool's sizes: N = T * B columns
GROUPS = (4, 8)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
VARIANT = {torch.float32: 0, torch.bfloat16: 1}
ROWS = (16, 64, 128)  # R the kernel takes: K5's, and K6's at G = 4 and 8

# Published H100 SXM rates (NVIDIA's data sheet, dense), for the bound.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12

# The f32 kernels' launch geometry, as csrc/dot_chain.cu sets it, and the
# H100 SXM it is sized for: an SM's 228 KB of shared memory (1 KB of it
# reserved a CTA), 2,048 threads and 64K registers.
THREADS = 256  # THREADS in dot_chain.cu
KS = 16  # depth of a staged weight slab
#: Registers a thread: the R x NC tile kernel (R = 64, 128) at most 65,536 / (2 x 256), as its
#: __launch_bounds__(256, 2) holds ptxas; the K5 kernel (R = 16) 40 (ptxas -v; chip_smoke prints it).
F32_REGS = {16: 40, 64: 128, 128: 128}
SM_SMEM, SM_THREADS, SM_REGS = 233472, 2048, 65536

#: Launches by ``chain`` (K5) and by ``packed`` (K6); the plain versions do not count.
chain_launches = 0
packed_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_dot_chain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nam_dot_chain.restype = ctypes.c_int
    lib.nam_dot_chain_ctas_per_sm.argtypes = [ctypes.c_int]
    lib.nam_dot_chain_ctas_per_sm.restype = ctypes.c_int


#: csrc/dot_chain.cu, built by nvcc at first launch.
LIB = _build.Library("dot_chain.cu", _bind)


def f32_cols(R: int) -> int:
    """Columns a CTA of the f32 kernel computes: THREADS threads of an 8 x 8
    tile over R rows, or of a 4 x 4 tile at R = 16 (K5)."""
    return THREADS * 16 // R if R == 16 else THREADS * 64 // R


def f32_smem_bytes(R: int) -> int:
    """Shared memory of an f32 CTA: y (R, f32_cols(R)) and two weight slabs
    of KS rows of R + 4 floats (step 0's operand slabs lie in y's space);
    at R = 16 the whole operand (3R, f32_cols(R)) and one slab."""
    if R == 16:
        return 4 * (3 * R * f32_cols(R) + KS * (R + 4))
    return 4 * (R * f32_cols(R) + 2 * KS * (R + 4))


def f32_ctas_per_sm(R: int) -> int:
    """f32 CTAs one SM holds at once: bound by shared memory, threads and registers."""
    return min(SM_SMEM // (f32_smem_bytes(R) + 1024), SM_THREADS // THREADS, SM_REGS // (F32_REGS[R] * THREADS))


def ctas_per_sm(R: int) -> int:
    """The CUDA runtime's count of the f32 kernel's CTAs an SM holds (on the card)."""
    return LIB.load().nam_dot_chain_ctas_per_sm(R)


def _check(x: torch.Tensor, w: torch.Tensor, dtype) -> None:
    if dtype not in VARIANT:
        raise ValueError(f"dtype {dtype} is neither torch.float32 nor torch.bfloat16")
    if w.dim() != 3 or w.shape[2] != K * w.shape[1] or w.shape[1] not in ROWS:
        raise ValueError(f"w shape {tuple(w.shape)} is not (S, R, 3R) with R in {ROWS}")
    if x.dim() != 2 or x.shape[0] != w.shape[2] or x.shape[1] < 1 or x.shape[1] % 4:
        raise ValueError(f"x shape {tuple(x.shape)} is not ({w.shape[2]}, N) with N a multiple of 4")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def launch(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """The whole chain in one launch on the current stream: (3R, N) float32."""
    _check(x, w, dtype)
    if not x.is_cuda:
        raise ValueError("the kernel runs on CUDA tensors")
    out = torch.empty_like(x)
    S, R, _ = w.shape
    lib = LIB.load()
    err = lib.nam_dot_chain(x.data_ptr(), w.data_ptr(), out.data_ptr(), S, R, x.shape[1], VARIANT[dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(err, "dot_chain kernel")
    return out


def chain_plain(x: torch.Tensor, w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The same chain on torch ops, float32 products with TF32 off; for
    bf16 the operands are rounded to bf16 first, as ``.astype(bfloat16)``."""
    _check(x, w, dtype)
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on; the plain version is exact float32")
    for s in range(w.shape[0]):
        ws = w[s]
        if dtype == torch.bfloat16:
            ws, x = ws.to(dtype).float(), x.to(dtype).float()
        y = torch.tanh(ws @ x)
        x = torch.cat([y, y, y])
    return x


def chain(x: torch.Tensor, w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """K5: x (3C, N), w (S, C, 3C) -> (3C, N). CUDA tensors go through the
    kernel, CPU tensors through ``chain_plain``."""
    global chain_launches
    if x.is_cuda:
        out = launch(x, w, dtype)
        chain_launches += 1
        return out
    if x.device.type == "cpu":
        return chain_plain(x, w, dtype)
    raise ValueError(f"dot chain runs on CUDA or CPU tensors, got {x.device}")


def _packed_check(x: torch.Tensor, w: torch.Tensor, G: int) -> None:
    shape = (L // G, G * C, G * K * C)
    if tuple(w.shape) != shape or x.dim() != 2 or x.shape[0] != G * K * C:
        raise ValueError(f"packed G={G}: w {tuple(w.shape)} must be {shape}, x ({G * K * C}, N), "
                         f"got {tuple(x.shape)}")


def packed_plain(x: torch.Tensor, w: torch.Tensor, G: int, dtype=torch.float32) -> torch.Tensor:
    """K6's plain version: the chain at the packed shapes."""
    _packed_check(x, w, G)
    return chain_plain(x, w, dtype)


def packed(x: torch.Tensor, w: torch.Tensor, G: int, dtype=torch.float32) -> torch.Tensor:
    """K6: G layers packed per step, x (G*3C, N), w (L // G, G*C, G*3C) ->
    (G*3C, N): L // G steps (2 at G = 8, as the tool runs)."""
    global packed_launches
    _packed_check(x, w, G)
    if x.is_cuda:
        out = launch(x, w, dtype)
        packed_launches += 1
        return out
    if x.device.type == "cpu":
        return packed_plain(x, w, G, dtype)
    raise ValueError(f"dot chain runs on CUDA or CPU tensors, got {x.device}")


def chain_library(x: torch.Tensor, w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The library yardstick: S cuBLAS products (``torch.matmul``, TF32 off;
    on bf16 operands for bf16, whose products round to bf16, so this is a
    timing yardstick only) with tanh and cat per step. ``w`` is already in
    ``dtype``. Timed beside the kernel; the port does not call it."""
    x = x.to(dtype)
    for s in range(w.shape[0]):
        y = torch.tanh(torch.matmul(w[s], x))
        x = torch.cat([y, y, y])
    return x.float()


def work(R: int, S: int, N: int, dtype=torch.float32) -> Dict[str, float]:
    """FLOPs (2 S R 3R N: every step's full product), the bytes that must
    move (x read once, the output written once, the float32 weights once) and
    the rate the variant runs at: float32 FMAs, or the bf16 tensor cores."""
    return {
        "flops": float(2 * S * R * K * R * N),
        "bytes": float(2 * K * R * N * 4 + S * R * K * R * 4),
        "flops_per_s": F32_FLOPS_PER_S if dtype == torch.float32 else BF16_TC_FLOPS_PER_S,
    }


def bound(wk: Dict[str, float]):
    """(bound in ms, "bytes" or "operations") of a ``work`` count."""
    tb, tf = wk["bytes"] / HBM_BYTES_PER_S, wk["flops"] / wk["flops_per_s"]
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def data(seed: int = 0, N: int = T * B) -> Dict[str, tuple]:
    """The sweep's operands, from ``np.random.default_rng(seed)`` at the
    tool's scale (x 0.1, w 0.1): the chain's, then the packed ones for each G."""
    rng = np.random.default_rng(seed)
    out = {"chain": (rng.standard_normal((K * C, N)).astype(np.float32) * 0.1,
                     rng.standard_normal((L, C, K * C)).astype(np.float32) * 0.1)}
    for G in GROUPS:
        out[f"G{G}"] = (rng.standard_normal((G * K * C, N)).astype(np.float32) * 0.1,
                        rng.standard_normal((L // G, G * C, G * K * C)).astype(np.float32) * 0.1)
    return out


def cases():
    """(name, kind, G, dtype name) of every run of the sweep."""
    for d in DTYPES:
        yield f"chain {d}", "chain", None, d
    for G in GROUPS:
        for d in DTYPES:
            yield f"packed G={G} {d}", f"G{G}", G, d


def time_ms(fn, n_iter: int = 50, n_warm: int = 5) -> float:
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
    global chain_launches, packed_launches
    from .. import resolve_device

    dev = resolve_device("cuda")  # raises without a card
    smi = card_and_power_limit()
    kind = torch.cuda.get_device_name(dev)
    print(f"device: {kind}  [{smi}]", flush=True)
    N = T * B
    operands = {k: (torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)) for k, (x, w) in data().items()}
    runs = {}
    chain_launches = packed_launches = 0
    for name, kind_key, G, d in cases():
        x, w = operands[kind_key]
        dtype = DTYPES[d]
        before = chain_launches + packed_launches
        if G is None:
            us = 1e3 * time_ms(lambda: chain(x, w, dtype))
        else:
            us = 1e3 * time_ms(lambda: packed(x, w, G, dtype))
        launched = chain_launches + packed_launches - before
        wl = w.to(dtype)
        lib_us = 1e3 * time_ms(lambda: chain_library(x, wl, dtype), n_iter=20, n_warm=2)
        S, R, _ = w.shape
        b_ms, b_by = bound(work(R, S, N, dtype))
        runs[name] = {"R": R, "S": S, "N": N, "dtype": d, "us": us, "library_us": lib_us, "bound_us": 1e3 * b_ms,
                      "bound_by": b_by, "launches": launched}
        print(f"{name}: {us:8.1f} us/block-of-B{B}  (bound {1e3 * b_ms:.1f} us, {b_by}; "
              f"library {lib_us:.1f} us)  [{smi}]", flush=True)
    print(json.dumps({"tool": "microbench_dots", "device": kind, "nvidia_smi": smi, "B": B, "T": T, "runs": runs,
                      "launches": {"chain": chain_launches, "packed": packed_launches}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
