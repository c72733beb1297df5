"""Diagnostic for the LSTM kernel (K2): is a warp's in-order chain per hidden
unit what sets its time?

Builds a variant of ``csrc/lstm.cu`` whose unit loop is unrolled by 2 (so the
compiler may interleave two units' independent chains) into
``build/kernels/probe/``, and times it against the committed kernel on the
same state and input, in turns (committed, variant, variant, committed), at
B = 2,048, 8,192 and 32,768 and T = 64 on the 2 x 16 LSTM. Needs a CUDA card:

    python3 -m neuralampmodelercore_tpu_torch.tools.lstm_unroll_probe
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

UNIT_LOOP = "      for (int j = 0; j < H; ++j) {\n        float zi"


def _build_variant(_build, lstm) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "lstm.cu").read_text()
    if src.count(UNIT_LOOP) != 1:
        raise RuntimeError("the unit loop of csrc/lstm.cu was not found once")
    (out / "lstm_unroll2.cu").write_text(src.replace(UNIT_LOOP, "#pragma unroll 2\n" + UNIT_LOOP))
    shutil.copy(_build.CSRC / "activations.cuh", out / "activations.cuh")
    so = out / "lstm_unroll2.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(out / "lstm_unroll2.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lstm._bind(lib)
    lib.nam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.nam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_unroll_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import neuralampmodelercore_tpu_torch as nam
    from neuralampmodelercore_tpu_torch.ops.cuda import _build, lstm
    from neuralampmodelercore_tpu_torch.tools.generate import make_nam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    committed, variant = lstm.LIB.load(), _build_variant(_build, lstm)
    model = nam.load_model(make_nam("LSTM", {"input_size": 1, "hidden_size": 16, "num_layers": 2}, seed=1234))
    cfg, T = model.config, 64
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run(lib, ep, st, x):
        lstm.LIB._lib = lib  # route the wrapper's launches through this build
        return lstm.step(cfg, T, ep, st, x)

    def ms_per_block(lib, ep, st, x, n_iter=20):
        for _ in range(3):
            run(lib, ep, st, x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            run(lib, ep, st, x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n_iter

    try:
        for B in (2048, 8192, 32768):
            ep, st = lstm.prepare(cfg, model.params, T, B)
            x = torch.randn((1, T, B), generator=gen, device="cuda") * 0.3
            s1 = {k: v.clone() for k, v in st.items()}
            s2 = {k: v.clone() for k, v in st.items()}
            y1, _ = run(committed, ep, s1, x)
            y2, _ = run(variant, ep, s2, x)
            torch.cuda.synchronize()
            err = max((y1 - y2).abs().max().item(), (s1["h"] - s2["h"]).abs().max().item(),
                      (s1["c"] - s2["c"]).abs().max().item())
            t = [ms_per_block(lib, ep, st, x) for lib in (committed, variant, variant, committed)]
            print(f"B={B} T={T}: committed {t[0]:.4f}/{t[3]:.4f} ms, unroll-2 {t[1]:.4f}/{t[2]:.4f} ms, "
                  f"max|variant - committed| {err:.2e}  [{smi}]", flush=True)
    finally:
        lstm.LIB._lib = committed
    return 0


if __name__ == "__main__":
    sys.exit(main())
