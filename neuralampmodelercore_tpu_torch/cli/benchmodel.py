"""benchmodel: wall-clock time to process 2 seconds of audio.

The reference protocol (reference: tools/benchmodel.cpp:103-143): process
(48000/64)*2 buffers of 64 frames of silence at 48 kHz and print wall-clock
ms; the real-time bar is 2000 ms. As the JAX package's cli/benchmodel.py,
with --batch (concurrent streams), --engine (the StreamEngine serving path:
the architecture's kernel on the card) and --fast-tanh (the reference
enables fast-tanh for benching, benchmodel.cpp:69-78); --device picks the
card (default) or the CPU. The timing ends with torch.cuda.synchronize().

    python -m neuralampmodelercore_tpu_torch.cli.benchmodel MODEL [--engine] [--fast-tanh] [--batch N]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nam-benchmodel", description=__doc__)
    ap.add_argument("model", help=".nam model file")
    ap.add_argument("--buffer", type=int, default=64, help="buffer size (default 64)")
    ap.add_argument("--batch", type=int, default=1, help="concurrent streams (default 1)")
    ap.add_argument("--seconds", type=float, default=2.0, help="audio length (default 2 s)")
    ap.add_argument("--engine", action="store_true", help="use the ring-state StreamEngine")
    ap.add_argument("--fast-tanh", action="store_true", help="enable fast-tanh mode")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    import neuralampmodelercore_tpu_torch as nam

    if args.fast_tanh:
        nam.activations.enable_fast_tanh()

    model = nam.load_model(args.model, device=args.device)
    sr = model.expected_sample_rate
    if sr <= 0:
        sr = 48000.0
    num_buffers = int((sr / args.buffer) * args.seconds)

    if args.engine:
        engine = nam.StreamEngine(model, batch=args.batch, block_size=args.buffer)
        state = engine.reset()
        x = torch.zeros((model.num_input_channels, args.buffer, args.batch), device=model.device)

        def step(s):
            return engine.step(s, x)
    else:
        state = model.reset(batch=args.batch, sample_rate=sr, max_buffer_size=args.buffer)
        x = torch.zeros((args.batch, args.buffer, model.num_input_channels), device=model.device)

        def step(s):
            return model.process(x, s)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    _, state = step(state)  # warm: builds the kernel on first use
    sync()
    t0 = time.perf_counter()
    for _ in range(num_buffers):
        _, state = step(state)
    sync()
    ms = (time.perf_counter() - t0) * 1e3

    bar = args.seconds * 1e3
    print(f"{ms:.1f} ms to process {args.seconds} s x {args.batch} streams "
          f"(buffer {args.buffer}); real-time bar {bar:.0f} ms; "
          f"{'REAL-TIME' if ms <= bar else 'not real-time'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
