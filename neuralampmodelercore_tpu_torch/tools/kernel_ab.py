"""Time one kernel of several checkouts on one card, in turns.

    python3 -m neuralampmodelercore_tpu_torch.tools.kernel_ab TREE [TREE ...] [--config flagship] \
        [--T 64] [--batch 2048]
    python3 -m neuralampmodelercore_tpu_torch.tools.kernel_ab TREE [TREE ...] --tool microbench_dots \
        [--case "packed G=8 f32" ...]

Each TREE is the root of a checkout (one holding neuralampmodelercore_tpu_torch/).
``--config`` names a config of this checkout's ``tools/agreement.py``, passed to
every tree as a .nam document; its architecture picks the kernel (WaveNet: the
stack kernel, LSTM: K2, ConvNet: K3, or their wide kernels where the wrapper's
gate sends the config there, as it sends ``--config large``, the reference's
LARGE preset), and a config of ``agreement.MODES`` runs
under its fast-tanh / LUT mode or on the wavefront path in every tree (a
tree whose kernel refuses that is skipped). Every tree builds that kernel (all builds
started together, each into the tree's own build/kernels/), then each
measurement runs in its own process with that tree first on sys.path, in the
order A, B, ..., B, A, so that a drift of the card shows as a difference
between the two turns of a tree. A measurement is the kernel's time per block
at ``--batch`` streams and blocks of ``--T`` frames (the main paths' shape,
B=2048 and T=64, unless given), from CUDA events over 20 calls after 3
warm-up calls, state carried from zero on the same input in every tree;
after the timed calls it prints the SHA-256 of the last block's output and
of the carried state, so that equal hashes across trees show a kernel's
outputs and state equal bit for bit. A tree whose kernel refuses the config
is skipped. A variant of a kernel is a
copy of the tree with its source edited (for example ``#pragma unroll 2``
before the unit loop of ``csrc/lstm.cu``). Prints the card's name and power
limit. Needs a CUDA card.

``--tool microbench_dots`` times the dot-chain kernel (csrc/dot_chain.cu, K5
and K6) instead: every tree builds it, then each turn (A, B, ..., B, A, one
process each) times every ``--case`` of the tool (a name of
``microbench_dots.cases()``; by default every f32 case) at the tool's shapes
and seed, 50 calls after 5 warm-up calls, and prints the SHA-256 of the
output's bytes, so that equal hashes across trees show outputs equal bit for
bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

KERNELS = {"WaveNet": "stack", "LSTM": "lstm", "ConvNet": "convnet"}

WORKER = r"""
import hashlib, importlib, json, sys, time
tree, kernel, doc_path, B, T, mode, modes = sys.argv[1:8]
B, T = int(B), int(T)
sys.path.insert(0, tree)
import torch
import neuralampmodelercore_tpu_torch as nam
mod = importlib.import_module("neuralampmodelercore_tpu_torch.ops.cuda." + kernel)
fast, luts, wavefront = json.loads(modes)
if mode == "build":
    # The wide kernel alone where the stack or ConvNet wrapper sends the
    # config there (stack.cu takes minutes in nvcc), else every source.
    t0 = time.perf_counter()
    libs = (mod.LIB, getattr(mod, "WF_LIB", None), getattr(mod, "WIDE_LIB", None))
    if kernel != "lstm" and not wavefront and mod._is_wide(nam.load_model(json.load(open(doc_path)), device="cpu").config, T):
        libs = (mod.WIDE_LIB,)
    for lib in libs:
        if lib is not None:
            lib.compile()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": [
        line.strip() for lib in libs if lib is not None for line in lib.build_log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line]}))
    sys.exit(0)
if fast:
    nam.activations.enable_fast_tanh()
for lut in luts:
    nam.activations.enable_lut(*lut)
if wavefront and not hasattr(mod, "WAVEFRONT"):
    print(json.dumps({"refused": "no wavefront path"}))
    sys.exit(0)
if wavefront:
    mod.WAVEFRONT = True
model = nam.load_model(json.load(open(doc_path)))
reason = mod.supports(model.config, T, B)
if reason is not None:
    print(json.dumps({"refused": reason}))
    sys.exit(0)
ep, st = mod.prepare(model.config, model.params, T, B)
gen = torch.Generator("cuda").manual_seed(0)
x = torch.randn((model.num_input_channels, T, B), device="cuda", generator=gen) * 0.3
box = {"s": st}
def run():
    box["y"], box["s"] = mod.step(model.config, T, ep, box["s"], x)
for _ in range(3):
    run()
torch.cuda.synchronize()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
for _ in range(20):
    run()
b.record()
torch.cuda.synchronize()
def tensors(s):  # the state's tensors in key order (a pre-pass's own state nested)
    for k in sorted(s):
        v = s[k]
        if torch.is_tensor(v):
            yield v
        elif isinstance(v, dict):
            yield from tensors(v)
h = hashlib.sha256()
for t in tensors(box["s"]):
    h.update(t.detach().cpu().numpy().tobytes())
print(json.dumps({"ms": a.elapsed_time(b) / 20, "y_sha256": hashlib.sha256(box["y"].cpu().numpy().tobytes()).hexdigest(),
                  "state_sha256": h.hexdigest()}))
"""


DOTS_WORKER = r"""
import hashlib, json, sys, time
tree, mode, names = sys.argv[1:4]
sys.path.insert(0, tree)
import torch
from neuralampmodelercore_tpu_torch.tools import microbench_dots as mbd
if mode == "build":
    t0 = time.perf_counter()
    mbd.LIB.compile()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": [
        line.strip() for line in mbd.LIB.build_log.splitlines() if "registers" in line or "spill" in line
        or "Compiling entry" in line]}))
    sys.exit(0)
data, cases = mbd.data(), {name: (key, G, d) for name, key, G, d in mbd.cases()}
out = {}
for name in json.loads(names):
    key, G, d = cases[name]
    x, w = (torch.from_numpy(a).cuda() for a in data[key])
    dtype = mbd.DTYPES[d]
    run = (lambda: mbd.chain(x, w, dtype)) if G is None else (lambda: mbd.packed(x, w, G, dtype))
    y = run()
    torch.cuda.synchronize()
    out[name] = {"ms": mbd.time_ms(run), "sha256": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()}
print(json.dumps(out))
"""


def _worker(tree: str, kernel: str, doc: str, mode: str, modes: str, B: int, T: int) -> dict:
    return _run([WORKER, tree, kernel, doc, str(B), str(T), mode, modes], f"{tree} ({mode})")


def _run(args, what: str) -> dict:
    out = subprocess.run([sys.executable, "-c", *args], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{what} failed:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def dots_ab(trees, names, smi: str) -> dict:
    """``--tool microbench_dots``: build in every tree, then time the cases
    in turns; returns {case: {tree: {"ms": [...], "sha256": [...]}}}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(trees)) as ex:
        builds = list(ex.map(lambda t: _run([DOTS_WORKER, t, "build", "[]"], f"{t} (build)"), trees))
    for tree, b in zip(trees, builds):
        print(f"build dot_chain.cu {tree}: {b['build_s']:.1f} s", flush=True)
        for line in b["ptxas"]:
            print(f"  ptxas {line}", flush=True)
    res = {name: {t: {"ms": [], "sha256": []} for t in trees} for name in names}
    for tree in trees + trees[::-1]:
        for name, r in _run([DOTS_WORKER, tree, "time", json.dumps(names)], f"{tree} (time)").items():
            res[name][tree]["ms"].append(r["ms"])
            res[name][tree]["sha256"].append(r["sha256"])
    for name, per_tree in res.items():
        hashes = {h for r in per_tree.values() for h in r["sha256"]}
        for tree, r in per_tree.items():
            print(f"{tree}: dot_chain {name}: " + ", ".join(f"{1e3 * m:.1f}" for m in r["ms"])
                  + f" us/call, sha256 {r['sha256'][0][:16]}  [{smi}]", flush=True)
        print(f"dot_chain {name}: outputs {'equal bit for bit in every tree' if len(hashes) == 1 else 'DIFFER'}",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--config", default="flagship", help="a config name of tools/agreement.py")
    ap.add_argument("--T", type=int, default=64, help="frames a block (default 64)")
    ap.add_argument("--batch", type=int, default=2048, help="streams (default 2048)")
    ap.add_argument("--tool", choices=("microbench_dots",), help="time the tool's kernel instead of a config's")
    ap.add_argument("--case", action="append", help="with --tool: a case of the tool (repeatable)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.profiling import card_and_power_limit
    from .agreement import MODES, configs
    from .generate import make_nam

    smi = card_and_power_limit()
    print(smi, flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    if args.tool:
        from .microbench_dots import cases

        names = args.case or [c[0] for c in cases() if c[3] == "f32"]
        unknown = sorted(set(names) - {c[0] for c in cases()})
        if unknown:
            ap.error(f"--case {unknown}: not a case of microbench_dots")
        dots_ab(trees, names, smi)
        return 0
    arch, config, seed = configs()[args.config]
    kernel = KERNELS[arch]
    modes = json.dumps(MODES.get(args.config, (False, (), False)))
    doc = Path(__file__).resolve().parents[2] / "build" / f"kernel_ab_{args.config}.nam"
    doc.parent.mkdir(parents=True, exist_ok=True)
    doc.write_text(json.dumps(make_nam(arch, config, seed=seed)))
    try:
        with ThreadPoolExecutor(len(trees)) as ex:
            builds = list(ex.map(lambda t: _worker(t, kernel, str(doc), "build", modes, args.batch, args.T), trees))
        for tree, b in zip(trees, builds):
            print(f"build {kernel} {tree}: {b['build_s']:.1f} s", flush=True)
            for line in b["ptxas"]:
                print(f"  ptxas {line}", flush=True)
        runs = {t: [] for t in trees}
        for tree in trees + trees[::-1]:
            res = _worker(tree, kernel, str(doc), "time", modes, args.batch, args.T)
            if "refused" in res:
                print(f"{tree}: {kernel} refuses {args.config}: {res['refused']}", flush=True)
                continue
            runs[tree].append(res)
        for tree, rs in runs.items():
            if rs:
                print(f"{tree}: {kernel} {args.config} B={args.batch} T={args.T}: "
                      + ", ".join(f"{1e3 * r['ms']:.1f}" for r in rs) + f" us/block, output sha256 "
                      f"{rs[0]['y_sha256'][:16]}, state sha256 {rs[0]['state_sha256'][:16]}  [{smi}]", flush=True)
        hashes = {(r["y_sha256"], r["state_sha256"]) for rs in runs.values() for r in rs}
        if hashes:
            print(f"{kernel} {args.config}: outputs and state "
                  f"{'equal bit for bit in every tree' if len(hashes) == 1 else 'DIFFER'}", flush=True)
    finally:
        doc.unlink()
    return 0


if __name__ == "__main__":
    sys.exit(main())
