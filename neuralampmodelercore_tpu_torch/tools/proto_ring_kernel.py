"""The ring-slot prototype (K4): a hand-written CUDA step, its plain version
and the prototype's run on the card.

    python -m neuralampmodelercore_tpu_torch.tools.proto_ring_kernel

The counterpart of the JAX package's ``tools/proto_ring_kernel.py``, whose
``step`` reaches ``pl.pallas_call`` at :57 (K4 in ROADMAP.md). One step
computes, for every tile i of TW columns,

    y[:, i*TW:(i+1)*TW] = 2 * ring[rslot, i] + x[:, i*TW:(i+1)*TW]
    ring[wslot, i] = x[:, i*TW:(i+1)*TW]             (in place)

with ``rslot = (n + 1) mod M`` and ``wslot = n mod M``; the ring is
(M, NT, C, TW), x and y are (C, NT * TW), float32. It shows the mechanics the
fused stack kernel rests on: slots computed on the device from a device
counter ``n`` (a 0-d int32 tensor; no host sync), one slot read, another
written in place on the ring's own storage, every other slot untouched.
The kernel is ``csrc/proto_ring.cu``; its header says what bounds it.

``step`` launches the kernel on CUDA tensors (or raises) and runs
``step_plain`` on CPU tensors; ``launches`` counts kernel launches and
nothing else. ``main`` is the prototype's run at its own shapes and seed:
one step at n = 2, checked exactly against the expectation, then a JSON
line. It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict

import numpy as np
import torch

from ..ops.cuda import _build
from ..utils.profiling import card_and_power_limit

M, NT, C, T, W = 4, 2, 8, 16, 128  # the prototype's shapes
TW = T * W

#: Kernel launches so far; ``step_plain`` and ``step_library`` do not count.
launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.nam_proto_ring_step.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nam_proto_ring_step.restype = ctypes.c_int


#: csrc/proto_ring.cu, built by nvcc at first launch.
LIB = _build.Library("proto_ring.cu", _bind)


def _shapes(ring: torch.Tensor, x: torch.Tensor, n: torch.Tensor):
    """(M, NT, C, TW) of a step's operands; raises on what the step does not take."""
    if ring.dim() != 4:
        raise ValueError(f"ring shape {tuple(ring.shape)} is not (M, NT, C, TW)")
    m, nt, c, tw = ring.shape
    if tuple(x.shape) != (c, nt * tw):
        raise ValueError(f"x shape {tuple(x.shape)} != {(c, nt * tw)}")
    if n.dim() != 0 or n.dtype != torch.int32:
        raise ValueError(f"n must be a 0-d int32 tensor, got {n.dtype} of shape {tuple(n.shape)}")
    for name, t in (("ring", ring), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if not (ring.device == x.device == n.device):
        raise ValueError(f"ring on {ring.device}, x on {x.device}, n on {n.device}")
    return m, nt, c, tw


def slots(n: torch.Tensor, m: int):
    """(rslot, wslot) as int64 tensors on n's device: (n + 1) mod M and n mod M."""
    n = n.long()
    return torch.remainder(n + 1, m), torch.remainder(n, m)


def launch(ring: torch.Tensor, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream; ring is updated in place."""
    global launches
    m, nt, c, tw = _shapes(ring, x, n)
    if not ring.is_cuda:
        raise ValueError("the kernel runs on CUDA tensors")
    y = torch.empty_like(x)
    lib = LIB.load()
    err = lib.nam_proto_ring_step(ring.data_ptr(), x.data_ptr(), y.data_ptr(), n.data_ptr(), m, nt, c, tw,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    LIB.check(err, "proto_ring kernel")
    launches += 1
    return y


def step(ring: torch.Tensor, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """One step: returns y and writes x into ring[wslot] in place. CUDA
    tensors go through the kernel, CPU tensors through ``step_plain``."""
    if x.is_cuda:
        return launch(ring, x, n)
    if x.device.type == "cpu":
        return step_plain(ring, x, n)
    raise ValueError(f"proto_ring step runs on CUDA or CPU tensors, got {x.device}")


def step_plain(ring: torch.Tensor, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The same step in plain torch, tile by tile as the TPU grid runs it."""
    m, nt, c, tw = _shapes(ring, x, n)
    rslot, wslot = slots(n, m)
    y = torch.empty_like(x)
    for i in range(nt):
        cols = slice(i * tw, (i + 1) * tw)
        y[:, cols] = ring[rslot, i] * 2.0 + x[:, cols]
        ring[wslot, i] = x[:, cols]
    return y


def step_library(ring: torch.Tensor, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The library yardstick: torch's own ops on the slots read from the
    device tensor (index_select, add with alpha=2, index_copy_). Timed beside
    the kernel; the port does not call it."""
    m, nt, c, tw = _shapes(ring, x, n)
    rslot, wslot = slots(n, m)
    chunk = ring.index_select(0, rslot.view(1))[0]  # (NT, C, TW)
    y = torch.add(x, chunk.permute(1, 0, 2).reshape(c, nt * tw), alpha=2)
    ring.index_copy_(0, wslot.view(1), x.view(c, nt, tw).permute(1, 0, 2).unsqueeze(0))
    return y


def work(m: int = M, nt: int = NT, c: int = C, tw: int = TW) -> Dict[str, float]:
    """What a step must move and compute: read a ring slot and x, write y and
    a ring slot (float32); one multiply and one add per element."""
    elems = nt * c * tw
    return {"bytes": float(4 * 4 * elems), "flops": float(2 * elems)}


def data(seed: int = 0):
    """The prototype's ring and x, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    ring = rng.standard_normal((M, NT, C, TW)).astype(np.float32)
    x = rng.standard_normal((C, NT * TW)).astype(np.float32)
    return ring, x


def expected(ring0: np.ndarray, x: np.ndarray, n: int):
    """The prototype's own expectation in numpy: (y, ring after the step)."""
    rslot, wslot = (n + 1) % M, n % M
    y = np.concatenate([ring0[rslot, i] * 2.0 + x[:, i * TW:(i + 1) * TW] for i in range(NT)], axis=1)
    ring1 = ring0.copy()
    for i in range(NT):
        ring1[wslot, i] = x[:, i * TW:(i + 1) * TW]
    return y, ring1


def main() -> int:
    global launches
    from .. import resolve_device

    dev = resolve_device("cuda")  # raises without a card
    ring0, x0 = data()
    ring = torch.from_numpy(ring0).to(dev)
    x = torch.from_numpy(x0).to(dev)
    n = torch.tensor(2, dtype=torch.int32, device=dev)  # wslot = 2, rslot = 3
    ptr = ring.data_ptr()
    launches = 0
    y = step(ring, x, n)
    torch.cuda.synchronize()
    count = launches
    exp_y, exp_ring = expected(ring0, x0, 2)
    err_y = float(np.abs(y.cpu().numpy() - exp_y).max())
    err_r = float(np.abs(ring.cpu().numpy() - exp_ring).max())
    print(f"y err: {err_y:.2e}   ring err: {err_r:.2e}")
    if not (err_y == 0.0 and err_r == 0.0 and ring.data_ptr() == ptr and count == 1):
        raise RuntimeError(f"mismatch: y {err_y}, ring {err_r}, in place {ring.data_ptr() == ptr}, launches {count}")
    print("prototype OK")
    smi = card_and_power_limit()
    print(json.dumps({"tool": "proto_ring_kernel", "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
                      "n": 2, "launches": count, "err_y": err_y, "err_ring": err_r, "in_place": True}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
