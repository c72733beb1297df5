"""Time the wide stack kernel (csrc/stack_wide.cu) at every register tile, on one card.

    python3 -m neuralampmodelercore_tpu_torch.tools.stack_wide_tiles [--paths large medium_gated flagship_T1024] \
        [--batch 2048]

For each path (a config of ``tools/agreement.py`` at its block size: large
and medium_gated at T = 64, flagship_T1024 the flagship at T = 1,024) and
each batch, the kernel runs at each (RT rows, FT columns) tile of
``ops.cuda.stack.WIDE_TILES`` (``prepare(..., wide_tile=...)``): first one
block from the zero state, whose output and state must be equal bit for bit
at every tile and within 2e-5 of ``step_plain``; then each tile's time per
block in turns (every tile, then every tile again in reverse order), from
CUDA events over 20 calls after 3 warm-up calls, state carried. Prints each
time with the wrapper's pick (``_wide_tile``) marked, the CTA's threads at
each tile, the card's name and power limit, and as its last line one JSON
object with every reading: the measurement behind ``_wide_tile``'s rule.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

PATHS = {"large": ("large", 64), "medium_gated": ("medium_gated", 64), "flagship_T1024": ("flagship", 1024)}
ATOL = 2e-5


def _time(fn, n_iter=20, n_warm=3):
    import torch

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n_iter):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n_iter


def sweep(path: str, batch: int, log=print) -> dict:
    """{"picked": [RT, FT], "tiles": {"RTxFT": {"ms": [..], "threads"}}, ...} of one path at one batch."""
    import torch

    import neuralampmodelercore_tpu_torch as nam
    from ..ops.cuda import stack
    from ..utils.profiling import card_and_power_limit
    from .agreement import configs
    from .generate import make_nam

    key, T = PATHS[path]
    arch, cfg_doc, seed = configs()[key]
    model = nam.load_model(make_nam(arch, cfg_doc, seed=seed))
    cfg = model.config
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((cfg.in_channels, T, batch), device="cuda", generator=gen) * 0.3
    tiles = sorted(stack.WIDE_TILES)
    out = {"T": T, "B": batch, "tiles": {}}
    hashes = set()
    for tile in tiles:
        ep, st = stack.prepare(cfg, model.params, T, batch, wide_tile=tile)
        lay = ep["layout"]
        if lay.wide is None or lay.wide.tile != tile:
            raise RuntimeError(f"{path}: the wide kernel does not run tile {tile}")
        buf = st["buf"].clone()
        y, st = stack.step(cfg, T, ep, st, x)
        yp = stack.step_plain(lay, ep["weights"], buf, x, 0)
        err = max((y - yp).abs().max().item(), (st["buf"] - buf).abs().max().item())
        if not err <= ATOL:
            raise RuntimeError(f"{path} tile {tile}: {err:.3e} from step_plain > {ATOL}")
        hashes.add(hashlib.sha256(y.cpu().numpy().tobytes() + st["buf"].cpu().numpy().tobytes()).hexdigest())
        out["tiles"][f"{tile[0]}x{tile[1]}"] = {"threads": lay.wide.threads, "ms": [], "max_abs_err_vs_plain": err}
        out["BS"], out["smem_bytes"], taps = lay.BS, lay.smem_bytes, lay.wide.tap_max > 0
        del ep, st, buf, y, yp
        torch.cuda.empty_cache()
    if len(hashes) != 1:
        raise RuntimeError(f"{path}: the tiles' first blocks differ")
    for tile in tiles + tiles[::-1]:
        ep, st = stack.prepare(cfg, model.params, T, batch, wide_tile=tile)
        box = {"s": st}

        def run():
            _, box["s"] = stack.step(cfg, T, ep, box["s"], x)

        out["tiles"][f"{tile[0]}x{tile[1]}"]["ms"].append(_time(run))
        del ep, st, box
        torch.cuda.empty_cache()
    out["picked"] = list(stack._wide_tile(taps))
    smi = card_and_power_limit()
    for name, r in out["tiles"].items():
        mark = "  <- picked" if name == f"{out['picked'][0]}x{out['picked'][1]}" else ""
        log(f"{path} B={batch} T={T} tile {name} ({r['threads']} threads, BS={out['BS']}): "
            + "/".join(f"{1e3 * m:.1f}" for m in r["ms"]) + f" us/block{mark}  [{smi}]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=list(PATHS))
    ap.add_argument("--batch", nargs="+", type=int, default=[2048])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("stack_wide_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    from ..ops.cuda import stack
    from ..utils.profiling import card_and_power_limit

    print(card_and_power_limit(), flush=True)
    stack.WIDE_LIB.load()
    for line in stack.WIDE_LIB.build_log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill", "stack frame")):
            print(f"ptxas stack_wide.cu: {line.strip()}", flush=True)
    res = {p: {b: sweep(p, b, log=lambda s: print(s, flush=True)) for b in args.batch} for p in args.paths}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
