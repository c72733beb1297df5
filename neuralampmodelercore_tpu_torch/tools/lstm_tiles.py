"""Time the LSTM tile kernel at every tile shape it can run, on one card.

    python3 -m neuralampmodelercore_tpu_torch.tools.lstm_tiles [--config lstm_48x2] [--batch 2048 8192]
    python3 -m neuralampmodelercore_tpu_torch.tools.lstm_tiles --sources 16x2 8x2 [--batch 2048 65536]

For each batch, on a config of ``tools/agreement.py`` (an LSTM that
``ops/cuda/lstm.py`` sends to csrc/lstm_wide.cu): the group kernel, then
the tile kernel at each (S streams a CTA, SPT streams a thread) whose
threads fill a warp and stay within TILE_MAX_THREADS and whose shared memory
fits, S / SPT in NGS, and the wrapper's pick. Each is timed per block at T = 64 with CUDA events
over 20 calls after 3 warm-up calls, state carried, and its first block's
output and state are held to the group kernel's bit for bit. Prints each
time with the wrapper's pick marked, the card's name and power limit, and as
its last line one JSON object with every reading. The measurement behind
``lstm._tile``'s rule.

With ``--sources HxL ...`` it times instead, for each LSTM of H units and L
layers (one input) and each batch, csrc/lstm.cu against csrc/lstm_wide.cu
(the kernel ``_tile`` picks there) in turns (lstm.cu, lstm_wide.cu,
lstm_wide.cu, lstm.cu), holds their first blocks' outputs within 1e-4 of
each other, and marks the source ``lstm._is_wide`` picks: the measurement
behind that rule.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

T = 64
NGS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)  # stream groups a CTA that are tried


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


def sweep(config: str, batch: int, log=print) -> dict:
    """{"group_ms", "picked": [S, SPT], "tiles": {"S,SPT": {"ms"}}} at one batch."""
    import torch

    import neuralampmodelercore_tpu_torch as nam
    from ..ops.cuda import lstm
    from .agreement import configs
    from .generate import make_nam

    arch, cfg_doc, seed = configs()[config]
    model = nam.load_model(make_nam(arch, cfg_doc, seed=seed))
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((cfg.in_channels, T, batch), device="cuda", generator=gen) * 0.3

    def timed(tile):
        """ms per block, and the first block's output and state from the initial state."""
        ep, st = lstm.prepare(cfg, model.params, T, batch, wide=True, tile=tile)
        first = {k: v.clone() for k, v in st.items()}
        y0, _ = lstm.step(cfg, T, ep, first, x)
        box = {"s": st}

        def run():
            _, box["s"] = lstm.step(cfg, T, ep, box["s"], x)

        return _time(run), y0, first

    g_ms, yg, sg = timed(False)
    picked = lstm._tile(cfg, batch)
    out = {"group_ms": g_ms, "picked": list(picked) if picked else None, "tiles": {}}
    H, lo = cfg.hidden_size, min(-(-32 // cfg.hidden_size), lstm.TILE_MAX_THREADS // cfg.hidden_size)
    tiles = sorted({(spt * ng, spt) for spt in lstm.TILE_SPT for ng in NGS
                    if lo <= ng <= lstm.TILE_MAX_THREADS // H
                    and lstm._tile_smem_bytes(cfg, spt * ng) <= lstm.SMEM_LIMIT} | {picked}, key=lambda t: (t[1], t[0]))
    for S, spt in tiles:
        ms, yt, st = timed((S, spt))
        if not (torch.equal(yt, yg) and all(torch.equal(st[k], sg[k]) for k in ("h", "c"))):
            raise RuntimeError(f"{config} B={batch} tile ({S}, {spt}) differs from the group kernel")
        out["tiles"][f"{S},{spt}"] = {"ms": ms}
        mark = "  <- picked" if picked == (S, spt) else ""
        log(f"{config} B={batch} tile S={S} SPT={spt} threads={H * S // spt}: {1e3 * ms:.1f} us{mark}")
    best = min(out["tiles"].items(), key=lambda kv: kv[1]["ms"])
    log(f"{config} B={batch}: group kernel {1e3 * g_ms:.1f} us; fastest tile {best[0]} "
        f"{1e3 * best[1]['ms']:.1f} us; picked {picked} {1e3 * out['tiles'][f'{picked[0]},{picked[1]}']['ms']:.1f} us")
    return out


def sources(hidden: int, layers: int, batch: int, log=print) -> dict:
    """{"lstm_cu_ms": [a, b], "lstm_wide_ms": [a, b], "tile": [S, SPT] or None, "picked"} at one batch."""
    import torch

    import neuralampmodelercore_tpu_torch as nam
    from ..ops.cuda import lstm
    from .generate import make_nam

    model = nam.load_model(make_nam("LSTM", {"input_size": 1, "hidden_size": hidden, "num_layers": layers}, seed=1))
    cfg = model.config
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((cfg.in_channels, T, batch), device="cuda", generator=gen) * 0.3
    out, first = {"lstm_cu_ms": [], "lstm_wide_ms": []}, {}
    for wide in (False, True, True, False):
        ep, st = lstm.prepare(cfg, model.params, T, batch, wide=wide)
        if wide not in first:
            first[wide] = lstm.step(cfg, T, ep, {k: v.clone() for k, v in st.items()}, x)[0]
        box = {"s": st}

        def run():
            _, box["s"] = lstm.step(cfg, T, ep, box["s"], x)

        out["lstm_wide_ms" if wide else "lstm_cu_ms"].append(_time(run))
        if wide:
            lay = ep["layout"]
            out["tile"] = [lay.tile, lay.tile_spt] if lay.tile else None
        del ep, st, box
    err = (first[True] - first[False]).abs().max().item()
    if not err <= 1e-4:
        raise RuntimeError(f"{hidden}x{layers} B={batch}: lstm.cu and lstm_wide.cu differ by {err:.3e}")
    out["picked"] = "lstm_wide.cu" if lstm._is_wide(cfg, batch) else "lstm.cu"
    a, w = out["lstm_cu_ms"], out["lstm_wide_ms"]
    log(f"{hidden}x{layers} B={batch}: lstm.cu {1e3 * a[0]:.1f}/{1e3 * a[1]:.1f} us, lstm_wide.cu "
        f"(tile {out['tile']}) {1e3 * w[0]:.1f}/{1e3 * w[1]:.1f} us; the wrapper picks {out['picked']}")
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+", default=["lstm_48x2", "lstm_2x16"], help="configs of tools/agreement.py")
    ap.add_argument("--batch", nargs="+", type=int, default=[2048, 8192, 32768])
    ap.add_argument("--sources", nargs="+", metavar="HxL",
                    help="time lstm.cu against lstm_wide.cu on these LSTMs (H units, L layers) instead")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lstm_tiles: needs a CUDA card", file=sys.stderr)
        return 2
    from ..utils.profiling import card_and_power_limit

    smi = card_and_power_limit()
    print(smi, flush=True)
    if args.sources:
        res = {f"{m} B={b}": sources(*map(int, m.split("x")), b) for m in args.sources for b in args.batch}
        print(json.dumps({"card": smi, "sources": res}))
        return 0
    res = {f"{c} B={b}": sweep(c, b) for c in args.config for b in args.batch}
    print(json.dumps({"card": smi, "sweeps": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
