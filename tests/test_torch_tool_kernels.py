"""The port's tools K4 (``tools/proto_ring_kernel.py``) and K5, K6
(``tools/microbench_dots.py``) against the JAX package's tools on the CPU.

The JAX tools are loaded by path, unchanged; their own ``step``,
``make_chain`` and ``make_packed`` run with the module's ``pl`` swapped for
one whose ``pallas_call`` runs in interpret mode, so the JAX side is the
tools' own kernel bodies under their own specs. On the CPU the port's
wrappers run their plain versions. Tolerances: K4 exact (0.0); f32 chains
2e-5 x max|output| at L = 20 (the tool's scale decays the output to about
2e-4) and 2e-5 absolute on the short chains and on K6 (outputs of order 1);
bf16 chains 2e-2 x max|output| (one bf16 rounding of a step's operand can
fall on the other side in the two frameworks)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralampmodelercore_tpu_torch.tools import microbench_dots as mbd
from neuralampmodelercore_tpu_torch.tools import proto_ring_kernel as prk

ROOT = Path(__file__).resolve().parents[1]
N_SMALL = 512  # columns: T = 64 frames x B = 8 streams, tiles of W = 4 streams -> 2 grid steps


class _Interpret:
    """``jax.experimental.pallas`` as the tools import it, with every
    ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _load_tool(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "pl", _Interpret())
    return mod


@pytest.fixture
def ring_tool(monkeypatch):
    return _load_tool("proto_ring_kernel", monkeypatch)


@pytest.fixture
def dots_tool(monkeypatch):
    mod = _load_tool("microbench_pallas_dots", monkeypatch)
    monkeypatch.setattr(mod, "B", N_SMALL // mod.T)
    return mod


# --- K4 ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 7])
def test_proto_ring_matches_jax_kernel(ring_tool, n):
    assert (ring_tool.M, ring_tool.NT, ring_tool.C, ring_tool.TW) == (prk.M, prk.NT, prk.C, prk.TW)
    ring0, x = prk.data()
    y_j, ring_j = ring_tool.step(jnp.asarray(ring0), jnp.asarray(x), jnp.asarray(n, jnp.int32))
    ring = torch.from_numpy(ring0.copy())
    storage = ring.data_ptr()
    y = prk.step(ring, torch.from_numpy(x), torch.tensor(n, dtype=torch.int32))
    assert ring.data_ptr() == storage  # written in place
    assert np.abs(y.numpy() - np.asarray(y_j)).max() == 0.0
    assert np.abs(ring.numpy() - np.asarray(ring_j)).max() == 0.0
    wslot = n % prk.M
    for m in range(prk.M):  # only wslot changed
        assert np.array_equal(ring.numpy()[m], ring0[m]) == (m != wslot)


def test_proto_ring_matches_the_tools_expectation():
    ring0, x = prk.data()
    ring = torch.from_numpy(ring0.copy())
    before = prk.launches
    y = prk.step(ring, torch.from_numpy(x), torch.tensor(2, dtype=torch.int32))
    exp_y, exp_ring = prk.expected(ring0, x, 2)
    assert np.abs(y.numpy() - exp_y).max() == 0.0 and np.abs(ring.numpy() - exp_ring).max() == 0.0
    assert prk.launches == before  # the plain version does not count


def test_proto_ring_library_yardstick_matches():
    ring0, x = prk.data()
    n = torch.tensor(5, dtype=torch.int32)
    ring_a, ring_b = torch.from_numpy(ring0.copy()), torch.from_numpy(ring0.copy())
    y_a = prk.step_plain(ring_a, torch.from_numpy(x), n)
    y_b = prk.step_library(ring_b, torch.from_numpy(x), n)
    assert torch.equal(y_a, y_b) and torch.equal(ring_a, ring_b)


def test_proto_ring_rejects_bad_operands():
    ring0, x = prk.data()
    ring, xt = torch.from_numpy(ring0), torch.from_numpy(x)
    with pytest.raises(ValueError, match="0-d int32"):
        prk.step(ring, xt, torch.tensor(2))  # int64
    with pytest.raises(ValueError, match="0-d int32"):
        prk.step(ring, xt, torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError, match="x shape"):
        prk.step(ring, xt[:, :100].contiguous(), torch.tensor(2, dtype=torch.int32))


# --- K5, K6 --------------------------------------------------------------------


def _dots_data(rows, steps, scale, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3 * rows, N_SMALL)).astype(np.float32) * 0.1
    w = rng.standard_normal((steps, rows, 3 * rows)).astype(np.float32) * scale
    return x, w


def _dtypes(name):
    return {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[name]


def _rel_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype,rel_tol", [("f32", 2e-5), ("bf16", 2e-2)])
def test_chain_matches_jax_kernel_full_length(dots_tool, dtype, rel_tol):
    """K5 at the tool's widths and depth (C = 16, K = 3, L = 20) and scale."""
    assert (dots_tool.C, dots_tool.K, dots_tool.L) == (mbd.C, mbd.K, mbd.L)
    jd, td = _dtypes(dtype)
    x, w = _dots_data(mbd.C, mbd.L, 0.1, seed=5)
    want = np.asarray(dots_tool.make_chain(4, jd, None)(jnp.asarray(x), jnp.asarray(w)))
    got = mbd.chain(torch.from_numpy(x), torch.from_numpy(w), td).numpy()
    assert got.shape == want.shape == (3 * mbd.C, N_SMALL)
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert _rel_err(got, want) <= rel_tol


@pytest.mark.parametrize("depth", [2, 3])
def test_chain_matches_jax_kernel_short(dots_tool, monkeypatch, depth):
    """Short chains at weights x 0.3, whose output is of order 1: absolute."""
    monkeypatch.setattr(dots_tool, "L", depth)
    x, w = _dots_data(mbd.C, depth, 0.3, seed=depth)
    want = np.asarray(dots_tool.make_chain(4, jnp.float32, None)(jnp.asarray(x), jnp.asarray(w)))
    got = mbd.chain(torch.from_numpy(x), torch.from_numpy(w), torch.float32).numpy()
    assert np.abs(want).max() > 0.05
    assert np.abs(got - want).max() <= 2e-5


@pytest.mark.parametrize("G", mbd.GROUPS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_packed_matches_jax_kernel(dots_tool, G, dtype):
    """K6 at the tool's packed shapes: L // G steps of (16G, 48G) products."""
    jd, td = _dtypes(dtype)
    x, w = _dots_data(G * mbd.C, mbd.L // G, 0.1, seed=G)
    want = np.asarray(dots_tool.make_packed(4, G, jd, None)(jnp.asarray(x), jnp.asarray(w)))
    got = mbd.packed(torch.from_numpy(x), torch.from_numpy(w), G, td).numpy()
    assert got.shape == want.shape == (3 * G * mbd.C, N_SMALL)
    if dtype == "f32":
        assert np.abs(got - want).max() <= 2e-5
    else:
        assert _rel_err(got, want) <= 2e-2


def test_packed_takes_the_tools_shapes_only():
    x, w = _dots_data(8 * mbd.C, 2, 0.1, seed=0)
    assert mbd.packed(torch.from_numpy(x), torch.from_numpy(w), 8).shape == (384, N_SMALL)
    with pytest.raises(ValueError, match="packed G=8"):  # 3 steps: G = 8 runs L // G = 2
        mbd.packed(torch.from_numpy(x), torch.from_numpy(np.concatenate([w, w[:1]])), 8)
    with pytest.raises(ValueError, match="packed G=4"):
        mbd.packed(torch.from_numpy(x), torch.from_numpy(w), 4)
    with pytest.raises(ValueError, match="neither"):
        mbd.chain(torch.zeros(48, 8), torch.zeros(2, 16, 48), torch.float16)
    with pytest.raises(ValueError, match="multiple of 4"):  # the kernel loads the operand in float4s
        mbd.chain(torch.zeros(48, 6), torch.zeros(2, 16, 48))
    with pytest.raises(ValueError, match="R in"):  # R = 32: no kernel instance
        mbd.chain(torch.zeros(96, 8), torch.zeros(2, 32, 96))


def test_dot_chain_library_yardstick_matches_in_f32():
    x, w = _dots_data(mbd.C, 4, 0.3, seed=9)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.allclose(mbd.chain_library(xt, wt), mbd.chain_plain(xt, wt), rtol=0, atol=1e-6)


def test_sweep_cases_and_data():
    names = [c[0] for c in mbd.cases()]
    assert names == ["chain f32", "chain bf16", "packed G=4 f32", "packed G=4 bf16", "packed G=8 f32",
                     "packed G=8 bf16"]
    d = mbd.data(N=64)
    assert [(k, x.shape, w.shape) for k, (x, w) in d.items()] == [
        ("chain", (48, 64), (20, 16, 48)), ("G4", (192, 64), (5, 64, 192)), ("G8", (384, 64), (2, 128, 384))]


# --- work counts, entry points -------------------------------------------------


@pytest.mark.parametrize("case,flops,f32_us,bf16_us", [
    ((16, 20), 2.013e9, 30.0, 7.5),     # K5
    ((64, 5), 8.05e9, 120.2, 30.0),     # K6, G = 4
    ((128, 2), 12.9e9, 192.3, 60.1),    # K6, G = 8
])
def test_dot_chain_work_and_bound(case, flops, f32_us, bf16_us):
    R, S = case
    N = mbd.T * mbd.B
    wk = mbd.work(R, S, N, torch.float32)
    assert wk["flops"] == 2 * S * R * 3 * R * N
    assert wk["bytes"] == 2 * 3 * R * N * 4 + 4 * S * R * 3 * R
    assert wk["flops"] == pytest.approx(flops, rel=2e-3)
    ms, by = mbd.bound(wk)
    assert (1e3 * ms, by) == (pytest.approx(f32_us, rel=5e-3), "operations")
    ms, by = mbd.bound(mbd.work(R, S, N, torch.bfloat16))
    assert (1e3 * ms, by) == (pytest.approx(bf16_us, rel=5e-3), "bytes")


@pytest.mark.parametrize("R,cols,smem,ctas_per_sm,ctas", [
    # K5: a 4 x 4 tile a thread, the whole (48, 256) operand and one (16, 20) slab; shared memory holds 4 an SM.
    (16, 256, 4 * (48 * 256 + 16 * 20), 4, 256),
    # K6 at G = 4 and 8: an 8 x 8 tile a thread, y (R, cols) and two (16, R + 4) slabs; 128 registers, 2 an SM.
    (64, 256, 4 * (64 * 256 + 2 * 16 * 68), 2, 256),
    (128, 128, 4 * (128 * 128 + 2 * 16 * 132), 2, 512),
])
def test_dot_chain_f32_launch_geometry(R, cols, smem, ctas_per_sm, ctas):
    """The f32 kernel's columns a CTA, shared memory and CTAs an SM at
    R = 16, 64 and 128, computed by hand (at R = 128: 128 columns, 82,432
    bytes, two CTAs an SM, 512 CTAs at N = 65,536, 1.94 waves on 132 SMs;
    the card tests hold the CTAs an SM against the CUDA runtime)."""
    N = mbd.T * mbd.B
    assert (mbd.f32_cols(R), mbd.f32_smem_bytes(R), mbd.f32_ctas_per_sm(R)) == (cols, smem, ctas_per_sm)
    assert -(-N // mbd.f32_cols(R)) == ctas
    assert mbd.f32_smem_bytes(R) + 1024 <= mbd.SM_SMEM // ctas_per_sm  # with the 1 KB each CTA reserves
    if R == 128:
        # Each CTA reads both steps' weights: 512 CTAs x 2 x 128 x 384 x 4 bytes through L2 a call, a
        # quarter of the 2,048 CTAs of 32 columns that a 4 x 4 tile makes at R = 128.
        assert ctas * 2 * R * 3 * R * 4 == 201326592 == (N // 32) * 2 * R * 3 * R * 4 // 4


def test_proto_ring_work_and_bound():
    wk = prk.work()
    assert wk["bytes"] == 4 * 131072 == 524288
    assert 1e6 * wk["bytes"] / mbd.HBM_BYTES_PER_S == pytest.approx(0.157, abs=1e-3)
    assert wk["bytes"] / mbd.HBM_BYTES_PER_S > wk["flops"] / mbd.F32_FLOPS_PER_S  # bound by bytes


@pytest.mark.parametrize("tool", [prk, mbd], ids=["proto_ring_kernel", "microbench_dots"])
def test_main_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
