"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. ``test_torch_gpu.py`` holds each CUDA kernel against its plain
version on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mm_masking_tpu.ops.pallas import nn_assoc as jnn
from mm_masking_tpu.ops.pallas.conv2d import _dk_nhcw_raw, _pad_cw, _pick_th, conv3x3_nhcw
from mm_masking_tpu_torch.benchmarks.timing import bound_ms
from mm_masking_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from mm_masking_tpu_torch.ops.kernels import nn_assoc as tnn
from mm_masking_tpu_torch.ops.kernels import _build
from mm_masking_tpu_torch.ops.kernels._build import use_kernel
from mm_masking_tpu_torch.ops.kernels.conv2d import (
    _rot180_t,
    ci_tile,
    conv3x3,
    conv3x3_dk_plain,
    pack_weight_bf16,
)
from mm_masking_tpu_torch.ops.kernels.conv_probes import VARIANTS


ULP = 2.0 ** -23  # one float32 ulp, relative


def conv_inputs(seed, B, H, W, Ci, Co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Ci, H, W)).astype(np.float32)
    k = (rng.standard_normal((3, 3, Ci, Co)) * 0.2).astype(np.float32)  # HWIO
    b = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("Ci,Co", [(1, 8), (8, 8), (16, 16)])
def test_conv3x3_matches_pallas(Ci, Co, relu, dtype):
    B, H, W = 2, 16, 40
    x, k, b = conv_inputs(0, B, H, W, Ci, Co)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = conv3x3_nhcw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jdt),
                        jnp.asarray(k).astype(jdt), jnp.asarray(b).astype(jdt), relu)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    tdt = getattr(torch, dtype)
    got = conv3x3(torch.from_numpy(x).to(tdt),
                  torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(tdt),
                  torch.from_numpy(b).to(tdt), relu)
    assert got.dtype == tdt and got.shape == (B, Co, H, W)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("Ci,Co", [(1, 8), (8, 8), (16, 16)])
def test_conv3x3_bf16_rounds_float32_weights_as_pallas(Ci, Co, relu):
    """A bfloat16 x with float32 weights and bias: the reference rounds kmat
    to x's type and keeps the bias in float32 (conv2d.py:236), and so does the
    port. Held against conv3x3_nhcw (interpret mode) at the bf16 limits of
    test_conv3x3_matches_pallas, and bit for bit against the port's own call
    on weights rounded to bf16 beforehand."""
    B, H, W = 2, 16, 40
    x, k, b = conv_inputs(0, B, H, W, Ci, Co)
    want = conv3x3_nhcw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jnp.bfloat16),
                        jnp.asarray(k), jnp.asarray(b), relu)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    xt = torch.from_numpy(x).bfloat16()
    w32 = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = conv3x3(xt, w32, torch.from_numpy(b), relu)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Co, H, W)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())
    assert torch.equal(got, conv3x3(xt, w32.bfloat16(), torch.from_numpy(b), relu))


def bf16_k_order(x: torch.Tensor, packed: torch.Tensor, co: int) -> torch.Tensor:
    """y (B, co, H, W) in float32, without bias, from x (bf16 values) and
    weights packed by pack_weight_bf16, summed in the order of the bfloat16
    conv kernel (csrc/conv3x3_bf16_tc.cu): chunk c holds input channels
    c·t .. c·t + t − 1, t = ci_tile(Ci); each tap's t products (exact in
    float32) are summed in float32 and the chunk's 9 taps into a fresh sum,
    which is added to the running sum in float32, chunk by chunk. The weight
    of (chunk c, tap 3·kh + kw, output channel o, channel k) is read where
    the kernel reads it: packed[c, tap, o, k]."""
    B, Ci, H, W = x.shape
    n_chunks, _, _, t = packed.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 0, n_chunks * t - Ci))
    wf = packed.float()
    acc = torch.zeros((B, wf.shape[2], H, W))
    for c in range(n_chunks):
        d = torch.zeros_like(acc)
        for tap in range(9):
            kh, kw = divmod(tap, 3)
            d = d + torch.einsum("bkhw,ok->bohw", xp[:, c * t:(c + 1) * t, kh:kh + H, kw:kw + W],
                                 wf[c, tap])
        acc = acc + d
    return acc[:, :co]


@pytest.mark.parametrize("use", ["forward", "dx"])
@pytest.mark.parametrize("cin", [1, 8, 12, 16])
def test_bf16_weight_packing_and_k_order(cin, use):
    """The bfloat16 kernel's weight packing and order of summation, emulated
    in torch (bf16_k_order) on the packed weights: within 1e-5 of max |y| of
    a float64 conv of the same bf16 values, before y is rounded. ``cin`` is
    the kernel's input channel count: x's for the forward, dy's for dx, whose
    weight is _rot180_t(weight), held against torch's conv2d_input (the
    adjoint). This checks the packing and the order, not the kernel: no CUDA
    code runs here. The kernel is held against a float64 conv on the card by
    test_conv3x3_bf16_matches_float64 and by chip_smoke.py."""
    B, H, W, other = 2, 12, 20, 12
    rng = np.random.default_rng(31 + cin)
    inp = torch.from_numpy(rng.standard_normal((B, cin, H, W)).astype(np.float32)).bfloat16()
    if use == "forward":
        w = torch.from_numpy(rng.standard_normal((other, cin, 3, 3)).astype(np.float32))
        w = (w * 0.2).bfloat16()
        packed, co = pack_weight_bf16(w), other
        want = F.conv2d(inp.double(), w.double(), padding=1)
    else:
        w = torch.from_numpy(rng.standard_normal((cin, other, 3, 3)).astype(np.float32))
        w = (w * 0.2).bfloat16()
        packed, co = pack_weight_bf16(_rot180_t(w)), other
        want = torch.nn.grad.conv2d_input((B, other, H, W), w.double(), inp.double(), padding=1)
    t = ci_tile(cin)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (-(-cin // t), 9, -(-co // 8) * 8, t)
    got = bf16_k_order(inp, packed, co)
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 → TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low mantissa
    bits rounded off, ties away from zero."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("Ci,Co", [(8, 8), (64, 64)])
def test_3xtf32_keeps_float32_accuracy(Ci, Co):
    """The arithmetic of the float32 conv kernel (csrc/conv3x3_tc.cu),
    emulated: each operand split into big = tf32(v) and small = tf32(v − big),
    the products small·big, big·small and big·big summed in float32 (a
    product of two TF32 values is exact in float32). Against a float64 conv
    it stays within 1e-5 of max |y|; one TF32 product, big·big alone, does
    not stay within the conv's 1e-4 limit, which is why the kernel splits."""
    x, k, _ = conv_inputs(11, 1, 12, 20, Ci, Co)
    w = np.ascontiguousarray(k.transpose(3, 2, 0, 1))  # HWIO → OIHW

    def conv(a, b):
        return F.conv2d(torch.from_numpy(a), torch.from_numpy(b), padding=1)

    x_big, w_big = tf32(x), tf32(w)
    x_small, w_small = tf32(x - x_big), tf32(w - w_big)
    y3 = conv(x_small, w_big) + conv(x_big, w_small) + conv(x_big, w_big)
    y1 = conv(x_big, w_big)
    y64 = F.conv2d(torch.from_numpy(x).double(), torch.from_numpy(w).double(), padding=1)
    scale = y64.abs().max().item()
    assert np.array_equal(tf32(x_big), x_big) and np.abs(x_small).max() <= 2.0 ** -11 * np.abs(x).max()
    assert (y3.double() - y64).abs().max().item() <= 1e-5 * scale
    assert (y1.double() - y64).abs().max().item() > 1e-4 * scale


def test_bound_ms_rates():
    """The H100's peaks behind every kernel's bound: 3.35 TB/s; float32 at
    67 TFLOP/s on the CUDA cores; matrix work on the tensor cores, float32
    through 3xTF32 at 495 / 3 TFLOP/s and bfloat16 at 989."""
    assert bound_ms(0.0, 3.35e9, torch.float32) == pytest.approx((1.0, "bytes"))
    assert bound_ms(67e9, 1.0, torch.float32) == pytest.approx((1.0, "operations"))
    assert bound_ms(165e9, 1.0, torch.float32, matmul=True) == pytest.approx((1.0, "operations"))
    assert bound_ms(989e9, 1.0, torch.bfloat16, matmul=True) == pytest.approx((1.0, "operations"))
    # One B=16 forward of 8 -> 8 at 640^2 moves 419 MB and is bound by them.
    ops, nbytes = 18 * 8 * 8 * 16 * 640 * 640, 4 * 16 * 640 * 640 * 16
    t, by = bound_ms(ops, nbytes, torch.float32, matmul=True)
    assert by == "bytes" and t == pytest.approx(0.1252, abs=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Ci", [1, 3, 8])
def test_conv3x3_dk_matches_pallas(Ci, dtype):
    """K3's plain version vs the Pallas dk kernel (interpret mode), fed as the
    JAX package's backward feeds it: C padded to the sublane tile, W to 128."""
    B, H, W, Co = 2, 16, 200, 8
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, Ci, H, W)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((B, Co, H, W)) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tile = 16 if dtype == "bfloat16" else 8
    Cip, Cop, Wp = max(tile, -(-Ci // tile) * tile), max(tile, -(-Co // tile) * tile), 256
    xj = _pad_cw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jdt), Cip, Wp)
    dyj = _pad_cw(jnp.asarray(dy).transpose(0, 2, 1, 3).astype(jdt), Cop, Wp)
    want = np.asarray(_dk_nhcw_raw(xj, dyj, _pick_th(H))).reshape(3, 3, Cip, Cop)[:, :, :Ci, :Co]
    tdt = getattr(torch, dtype)
    got = conv3x3_dk_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (Co, Ci, 3, 3)
    got = got.permute(2, 3, 1, 0).numpy()  # OIHW → HWIO
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def dk_tile_order(x: torch.Tensor, dy: torch.Tensor, th: int, tw: int,
                  tiles_per_chunk: int, split: bool = False) -> torch.Tensor:
    """dk (Co, Ci, 3, 3) summed in the order of K3's bfloat16 kernel
    (csrc/conv3x3_dk_tc.cu), from float32 x and dy that hold bf16 values:
    each spatial tile of th × tw pixels (zero past the image) summed alone in
    float32, where each product is exact; the tiles of a chunk (consecutive
    tiles in (b, tile row, tile column) order) added in float32 in order;
    then the chunks added in chunk order. ``split``: the arithmetic of K3's
    float32 kernel (csrc/conv3x3_dk_tf32_tc.cu) on float32 x and dy, each
    split into big = tf32(v) and small = tf32(v − big), a tile's sum taken
    as the products small·big, then big·small, then big·big (each exact in
    float32)."""
    B, Ci, H, W = x.shape
    Co = dy.shape[1]
    nth, ntw = -(-H // th), -(-W // tw)
    Hp, Wp = nth * th, ntw * tw
    pairs = [(x, dy)]
    if split:
        xb, db = (torch.from_numpy(tf32(t.numpy())) for t in (x, dy))
        xs, ds = (torch.from_numpy(tf32((t - b).numpy())) for t, b in ((x, xb), (dy, db)))
        pairs = [(xs, db), (xb, ds), (xb, db)]
    tiles = 0
    for xt, dt in pairs:
        xp = F.pad(xt, (1, 1 + Wp - W, 1, 1 + Hp - H))
        d = F.pad(dt, (0, Wp - W, 0, Hp - H)).reshape(B, Co, nth, th, ntw, tw)
        taps = [torch.einsum("bihpwq,bohpwq->bhwoi",
                             xp[:, :, kh:kh + Hp, kw:kw + Wp].reshape(B, Ci, nth, th, ntw, tw), d)
                for kh in range(3) for kw in range(3)]
        tiles = tiles + torch.stack(taps, -1).reshape(B * nth * ntw, Co, Ci, 9)
    n_chunks = -(-len(tiles) // tiles_per_chunk)
    tiles = F.pad(tiles, (0, 0, 0, 0, 0, 0, 0, n_chunks * tiles_per_chunk - len(tiles)))
    tiles = tiles.reshape(n_chunks, tiles_per_chunk, Co, Ci, 9)
    partial = torch.zeros_like(tiles[:, 0])
    for j in range(tiles_per_chunk):
        partial = partial + tiles[:, j]
    dk = torch.zeros_like(partial[0])
    for c in range(n_chunks):
        dk = dk + partial[c]
    return dk.reshape(Co, Ci, 3, 3)


# The kernel's tiles: 16 x 40 pixels below 16 input channels, 8 x 40 from 16
# on; a few tiles a chunk, so that both the runs within a chunk and the sum
# over chunks are taken.
@pytest.mark.parametrize("Ci,Co,H,W,th,per_chunk", [(1, 8, 48, 80, 16, 4), (64, 64, 16, 40, 8, 2)])
def test_dk_bf16_tile_sums_keep_float32_accuracy(Ci, Co, H, W, th, per_chunk):
    """K3's bf16 order of summation, emulated: within 1e-5 of max |dk| of a
    float64 sum of the same bf16 inputs, and equal to the Pallas dk kernel
    (interpret mode, bf16) within the bf16 limit of the test above. This
    checks the order of summation, not the kernel: no code of the port runs
    here. The kernel's own accuracy is held on the card by
    test_conv3x3_dk_bf16_matches_float64 and by chip_smoke.py."""
    B = 2
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((B, Ci, H, W)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((B, Co, H, W)) * 0.1).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16().float()
    dyb = torch.from_numpy(dy).bfloat16().float()
    got = dk_tile_order(xb, dyb, th, 40, per_chunk)
    want64 = torch.nn.grad.conv2d_weight(xb.double(), got.shape, dyb.double(), padding=1)
    scale = want64.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= 1e-5 * scale

    Cip, Cop, Wp = max(16, -(-Ci // 16) * 16), max(16, -(-Co // 16) * 16), -(-W // 128) * 128
    xj = _pad_cw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jnp.bfloat16), Cip, Wp)
    dyj = _pad_cw(jnp.asarray(dy).transpose(0, 2, 1, 3).astype(jnp.bfloat16), Cop, Wp)
    want = np.asarray(_dk_nhcw_raw(xj, dyj, _pick_th(H))).reshape(3, 3, Cip, Cop)[:, :, :Ci, :Co]
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


# The float32 kernel's tiles: 32 x 40 pixels for Ci = 1, 4 x 40 from 33
# output channels on; a few tiles a chunk, so that both the runs within a
# chunk and the sum over chunks are taken.
@pytest.mark.parametrize("Ci,Co,H,W,th,per_chunk", [(1, 8, 48, 80, 32, 2), (64, 64, 16, 40, 4, 3)])
def test_dk_3xtf32_tile_sums_keep_float32_accuracy(Ci, Co, H, W, th, per_chunk):
    """K3's float32 arithmetic emulated: x and dy split into TF32 halves, the
    three products of each tile summed in float32 in the kernel's order,
    then the tiles of each chunk, then the chunks in chunk order. Within
    1e-5 of max |dk| of a float64 sum of the float32 inputs (one TF32
    product, big·big alone, is not), and equal to the Pallas dk kernel
    (interpret mode, f32) within the f32 limit of
    test_conv3x3_dk_matches_pallas. This checks the split and the order of
    summation, not the kernel: no code of the port runs here. The kernel's
    own accuracy is held on the card by test_conv3x3_dk_f32_matches_float64
    and by chip_smoke.py."""
    B = 2
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((B, Ci, H, W)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((B, Co, H, W)) * 0.1).astype(np.float32)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = dk_tile_order(xt, dyt, th, 40, per_chunk, split=True)
    want64 = torch.nn.grad.conv2d_weight(xt.double(), got.shape, dyt.double(), padding=1)
    scale = want64.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= 1e-5 * scale
    one = dk_tile_order(torch.from_numpy(tf32(x)), torch.from_numpy(tf32(dy)), th, 40, per_chunk)
    assert (one.double() - want64).abs().max().item() > 1e-5 * scale

    Cip, Cop, Wp = max(8, -(-Ci // 8) * 8), max(8, -(-Co // 8) * 8), -(-W // 128) * 128
    xj = _pad_cw(jnp.asarray(x).transpose(0, 2, 1, 3), Cip, Wp)
    dyj = _pad_cw(jnp.asarray(dy).transpose(0, 2, 1, 3), Cop, Wp)
    want = np.asarray(_dk_nhcw_raw(xj, dyj, _pick_th(H))).reshape(3, 3, Cip, Cop)[:, :, :Ci, :Co]
    np.testing.assert_allclose(got.permute(2, 3, 1, 0).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,entry,sizing", [
    (torch.float32, "mm_conv3x3_dk_f32", "mm_conv3x3_dk_chunks"),
    (torch.bfloat16, "mm_conv3x3_dk_bf16", "mm_conv3x3_dk_bf16_chunks"),
])
def test_conv3x3_dk_routes_each_precision_to_its_entry(monkeypatch, dtype, entry, sizing):
    """On the card, K3 takes float32 to conv3x3_dk_tf32_tc.cu and bfloat16 to
    conv3x3_dk_tc.cu, each with the scratch its own host function sizes."""
    from mm_masking_tpu_torch.ops.kernels import conv2d

    calls = []
    chunks = {"mm_conv3x3_dk_chunks": 3, "mm_conv3x3_dk_bf16_chunks": 5}

    def record(name, result):
        return staticmethod(lambda *args: calls.append((name, args)) or result)

    Library = type("Library", (), {
        **{name: record(name, n) for name, n in chunks.items()},
        **{name: record(name, 0) for name in ("mm_conv3x3_dk_f32", "mm_conv3x3_dk_bf16")},
    })
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(conv2d, "library", Library)
    monkeypatch.setattr(conv2d, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    x = torch.zeros((2, 3, 5, 6), dtype=dtype)
    dy = torch.zeros((2, 4, 5, 6), dtype=dtype)
    reset_launch_counts()
    dk = conv2d.conv3x3_dk(x, dy)
    assert dk.dtype == torch.float32 and dk.shape == (4, 3, 3, 3)
    assert launch_counts()["conv3x3_dk"] == 1
    reset_launch_counts()
    (sized, size_args), (launched, args) = calls
    assert sized == sizing and size_args == (2, 3, 4, 5, 6)
    assert launched == entry and args[4:] == (2, 3, 4, 5, 6, chunks[sizing], 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_routes_each_precision_to_its_entry(monkeypatch, dtype):
    """On the card, K2 takes float32 to conv3x3_tc.cu (sized by Co, W) and
    bfloat16 to conv3x3_bf16_tc.cu (sized by Ci, Co) with the weights of
    pack_weight_bf16, for the forward and, on the rotated and transposed
    weight, for dx; a shape whose block needs more shared memory than a block
    may have raises before any launch."""
    from mm_masking_tpu_torch.ops.kernels import conv2d

    calls, packed_bytes = [], [0]
    smem = {"mm_conv3x3_f32_smem_bytes": 5000, "mm_conv3x3_bf16_smem_bytes": 7000}

    def record(name, result):
        def fn(*args):
            if name == "mm_conv3x3_bf16":  # the weights it is handed, read while they live
                args = (args[0], ctypes.string_at(args[1], packed_bytes[0]), *args[2:])
            calls.append((name, args))
            return result
        return staticmethod(fn)

    Library = type("Library", (), {
        **{name: record(name, n) for name, n in smem.items()},
        **{name: record(name, 0) for name in ("mm_conv3x3_f32", "mm_conv3x3_bf16")},
    })
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(conv2d, "library", Library)
    monkeypatch.setattr(conv2d, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 3, 5, 6)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((2, 4, 5, 6)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    b = torch.zeros(4)
    bf = dtype == torch.bfloat16
    entry, sizing = ("mm_conv3x3_bf16", "mm_conv3x3_bf16_smem_bytes") if bf else (
        "mm_conv3x3_f32", "mm_conv3x3_f32_smem_bytes")
    reset_launch_counts()
    for fn, args, wk, shape in ((conv2d.conv3x3_forward, (x, w, b, True), w, (2, 3, 4, 5, 6, 1)),
                                (conv2d.conv3x3_dx, (dy, w), _rot180_t(w), (2, 4, 3, 5, 6, 0))):
        packed = pack_weight_bf16(wk).view(torch.int16).numpy().tobytes()
        packed_bytes[0] = len(packed)
        calls.clear()
        out = fn(*args)
        assert out.dtype == dtype and out.shape == (2, shape[2], 5, 6)
        (sized, size_args), (launched, largs) = calls
        assert sized == sizing and launched == entry
        assert size_args == (shape[1:3] if bf else (shape[2], 6))
        assert largs[4:] == (*shape, 7)
        if bf:
            assert largs[1] == packed
    assert (launch_counts()["conv3x3"], launch_counts()["conv3x3_dx"]) == (1, 1)
    monkeypatch.setattr(conv2d, "SMEM_LIMIT", smem[sizing] - 1)
    calls.clear()
    with pytest.raises(ValueError, match="shared memory"):
        conv2d.conv3x3_forward(x, w, b)
    assert [name for name, _ in calls] == [sizing]
    assert launch_counts()["conv3x3"] == 1
    reset_launch_counts()


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_gradients_match_pallas_vjp(relu):
    """jax.grad through conv3x3_nhcw's custom VJP (Pallas dx and dk in
    interpret mode) vs the port's autograd Function on the CPU."""
    B, H, W, Ci, Co = 2, 16, 40, 3, 8
    x, k, b = conv_inputs(4, B, H, W, Ci, Co)
    # Scaled so that dk, a sum over B·H·W products, is of order 1.
    cot = (np.random.default_rng(5).standard_normal((B, Co, H, W)) * 0.02).astype(np.float32)

    def loss(xj, kj, bj):
        y = conv3x3_nhcw(xj.transpose(0, 2, 1, 3), kj, bj, relu)
        return jnp.sum(y * jnp.asarray(cot).transpose(0, 2, 1, 3))

    gx, gk, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = conv3x3(xt, wt, bt, relu)
    assert type(y.grad_fn).__name__ == "_Conv3x3Backward"
    tx, tw, tb = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(cot))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.permute(2, 3, 1, 0).numpy(), np.asarray(gk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(gb), rtol=0, atol=1e-5)


def test_first_conv_takes_no_dx():
    """An input that needs no gradient (the UNet's image) gets no dx."""
    x, k, b = conv_inputs(6, 1, 8, 12, 1, 8)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    y = conv3x3(torch.from_numpy(x), w, torch.from_numpy(b), True)
    (gw,) = torch.autograd.grad(y.sum(), (w,))
    assert gw.shape == w.shape and torch.isfinite(gw).all()


def test_backward_hands_the_kernels_contiguous_tensors(monkeypatch):
    """The cotangent that cat hands a decoder conv is a channel slice; the
    backward copies it before the innermost calls, which on the card need
    contiguous NCHW."""
    from mm_masking_tpu_torch.ops.kernels import conv2d

    seen = []
    for name in ("conv3x3_dx_plain", "conv3x3_dk_plain"):
        fn = getattr(conv2d, name)

        def spy(a, b, fn=fn):
            seen.append(a.is_contiguous() and b.is_contiguous())
            return fn(a, b)

        monkeypatch.setattr(conv2d, name, spy)
    x, k, b = conv_inputs(7, 2, 8, 12, 4, 4)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    inner = conv3x3(xt, w, torch.from_numpy(b), True)
    outer = conv3x3(torch.cat([inner, inner * 2.0], dim=1)[:, 2:6], w, torch.from_numpy(b))
    torch.autograd.grad(outer.sum(), (xt, w))
    assert len(seen) == 4 and all(seen)


def scene_points(seed, B, N, M):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    q = rng.uniform(-30, 30, (B, M, 3)).astype(np.float32)
    q[:, -7:] = 1000.0  # map pad rows
    q[:, 11] = q[:, 5]  # exact duplicate: the first occurrence must win
    return p, q


def test_nn_argmin_matches_pallas_interpret():
    p, q = scene_points(6, 2, 160, 1300)
    idx_j, d2_j = jnn.nn_argmin_pallas(jnp.asarray(p), jnp.asarray(q), tn=128, tm=512,
                                       interpret=True)
    idx_t, d2_t = tnn.nn_argmin(torch.from_numpy(p), torch.from_numpy(q))
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # XLA contracts the interpreted kernel's multiply-adds: one float32 ulp.
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=ULP, atol=1e-6)
    assert not (idx_t == 11).any()  # duplicate of row 5 never chosen


def test_nn_argmin_matches_blocked():
    p, q = scene_points(7, 2, 200, 2048)
    idx_j, d2_j = jnn.nn_argmin_blocked(jnp.asarray(p), jnp.asarray(q), chunk=512)
    idx_t, d2_t = tnn.nn_argmin(torch.from_numpy(p), torch.from_numpy(q))
    # The blocked oracle expands |p|² − 2p·q + |q|²: its rounding error scales
    # with |p|² + |q|², not with d2 (bound: a few ulps of that magnitude).
    real = q[:, :-7]
    err = 8 * ULP * ((p ** 2).sum(-1).max() + (real ** 2).sum(-1).max())
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-4, atol=err)
    d_all = ((p[:, :, None] - q[:, None]) ** 2).sum(-1)
    part = np.partition(d_all, 1, axis=2)
    clear = (part[..., 1] - part[..., 0]) > 2 * err
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(idx_t.numpy()[clear], np.asarray(idx_j)[clear])


def stripe_case(seed=8, B=3, N=256, M=2048, tn=64, tm=256):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, M, 3), np.float32)
    q[..., 0] = np.sort(rng.uniform(-50, 50, (B, M)), axis=1)
    q[..., 1] = rng.uniform(-5, 5, (B, M))
    p = np.zeros((B, N, 3), np.float32)
    p[..., 0] = np.sort(rng.uniform(-45, 45, (B, N)), axis=1)
    p[..., 1] = rng.uniform(-5, 5, (B, N))
    T = N // tn
    start = rng.integers(0, M // tm - 2, (B, T)).astype(np.int32)
    nblk = rng.integers(1, 3, (B, T)).astype(np.int32)
    nblk[1] = 0  # a frozen item: no association at all
    return p, q, start, nblk, tn, tm


def test_nn_stripe_matches_pallas_interpret():
    p, q, start, nblk, tn, tm = stripe_case()
    idx_j, d2_j = jnn._nn_stripe_pallas(
        jnp.pad(jnp.asarray(p), ((0, 0), (0, 0), (0, 5))), jnn.coord_major(jnp.asarray(q)),
        jnp.asarray(start), tn=tn, tm=tm, nk=int(nblk.max()), interpret=True,
        nblk=jnp.asarray(nblk))
    idx_t, d2_t = tnn.nn_stripe(torch.from_numpy(p), torch.from_numpy(q),
                                torch.from_numpy(start), torch.from_numpy(nblk), tm)
    live = np.repeat(nblk > 0, tn, axis=1)
    np.testing.assert_array_equal(idx_t.numpy()[live], np.asarray(idx_j)[live])
    np.testing.assert_allclose(d2_t.numpy()[live], np.asarray(d2_j)[live], rtol=ULP,
                               atol=1e-6)


def test_nn_stripe_all_infinite_row_matches_pallas():
    """A row of a live tile with no finite distance (a NaN scan point, as a
    non-finite pose makes; or one so far out that every d2 overflows) gets
    idx 0 and d2 inf, as the TPU kernel gives, whichever block its tile
    starts at."""
    p, q, start, nblk, tn, tm = stripe_case(seed=16)
    start[:, 0], nblk[:, 0] = 3, 2  # tile 0 of every item is live, from block 3
    p[:, 5] = np.nan
    p[0, 70] = (1e30, 0.0, 0.0)  # tile 1 of item 0
    assert nblk[0, 1] > 0
    idx_j, d2_j = jnn._nn_stripe_pallas(
        jnp.pad(jnp.asarray(p), ((0, 0), (0, 0), (0, 5))), jnn.coord_major(jnp.asarray(q)),
        jnp.asarray(start), tn=tn, tm=tm, nk=int(nblk.max()), interpret=True,
        nblk=jnp.asarray(nblk))
    idx_t, d2_t = tnn.nn_stripe(torch.from_numpy(p), torch.from_numpy(q),
                                torch.from_numpy(start), torch.from_numpy(nblk), tm)
    live = np.repeat(nblk > 0, tn, axis=1)
    np.testing.assert_array_equal(idx_t.numpy()[live], np.asarray(idx_j)[live])
    np.testing.assert_allclose(d2_t.numpy()[live], np.asarray(d2_j)[live], rtol=ULP, atol=1e-6)
    assert (idx_t[:, 5] == 0).all() and idx_t[0, 70] == 0
    assert torch.isinf(d2_t[:, 5]).all() and torch.isinf(d2_t[0, 70])


@pytest.mark.parametrize("mode", ["dense", "stripe"])
def test_nan_map_point_is_never_chosen_and_its_block_still_counts(mode):
    """The port's rule for a NaN map point (ROADMAP §3, Decisions): its pairs
    are never chosen, and the other points of its map block still count.
    (The TPU kernels drop the whole block, a result that depends on their
    block size.) The expected neighbours come from numpy in float32 in the
    kernel's order of operations."""
    rng = np.random.default_rng(17)
    B, N, M, tm = 2, 64, 1024, 256
    q = rng.uniform(-30, 30, (B, M, 3)).astype(np.float32)
    q[:, 10, 0] = np.nan  # in block 0, beside the scan points' neighbours
    p = (q[:, 20:20 + N] + rng.normal(0, 0.01, (B, N, 3))).astype(np.float32)
    dx, dy, dz = (p[:, :, None, c] - q[:, None, :, c] for c in range(3))
    d = dx * dx + dy * dy + dz * dz
    d = np.where(np.isnan(d), np.float32(np.inf), d)
    want = d.argmin(axis=2)
    assert (want < tm).all()  # every neighbour lies in the NaN point's block
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    if mode == "dense":
        idx, d2 = tnn.nn_argmin_plain(pt, qt)
    else:
        start = torch.zeros((B, 1), dtype=torch.int32)
        idx, d2 = tnn.nn_stripe_plain(pt, qt, start, torch.full_like(start, M // tm), tm)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(d2.numpy(), np.take_along_axis(d, want[..., None], 2)[..., 0])


def tie_heavy_case(seed, B, N, M):
    """Scan and map points on a coarse grid (every distance exact in float32,
    many equal), exact duplicate map points across unit boundaries, map pad
    rows at 1000, and rows with no finite distance: a NaN scan point and
    one whose every d2 overflows."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(-12, 12, (B, N, 3)) * 0.5).astype(np.float32)
    q = (rng.integers(-12, 12, (B, M, 3)) * 0.5).astype(np.float32)
    p[..., 2] = np.where(rng.random((B, N)) < 0.5, 0.0, 0.5)
    q[..., 2] = np.where(rng.random((B, M)) < 0.5, 0.0, 0.5)
    q[:, M // 2:M // 2 + 40] = q[:, 7:47]
    q[:, -9:] = 1000.0
    p[:, 3] = np.nan
    p[:, 4] = (1e30, 0.0, 0.0)
    return p, q


def unit_merge(p, q, ranges, span, chunk, rng):
    """csrc/nn_assoc.cu's order of work, emulated in torch for the rows p
    (R, 3) of one tile against q (M, 3): each map range [lo, hi) of
    ``ranges`` cut into units of ``span`` points, each unit in chunks of
    ``chunk`` (the last padded with NaN points) with the chunk minimum by
    fmin, compared with the running best once per chunk on a strict <, and
    the first point of the best chunk equal to it; the units' packed
    (d2 bits << 32 | idx) merged by their minimum into an all-ones preset, in
    a shuffled order; all ones unpacks to (0, inf). Returns (idx, d2)."""
    keys = np.full(p.shape[0], np.iinfo(np.uint64).max, np.uint64)
    units = [s0 for lo, hi in ranges for s0 in range(lo, hi, span)]
    hi_of = {s0: hi for lo, hi in ranges for s0 in range(lo, hi, span)}
    rng.shuffle(units)  # the units finish in any order
    rows = torch.arange(p.shape[0])
    for s0 in units:
        n = min(span, hi_of[s0] - s0)
        nc = -(-n // chunk)
        d = F.pad(tnn._sq_dist(p, q[s0:s0 + n]), (0, nc * chunk - n), value=float("nan"))
        d = d.reshape(p.shape[0], nc, chunk)
        best = torch.full((p.shape[0],), float("inf"))
        best_c = torch.zeros(p.shape[0], dtype=torch.int64)
        for c in range(nc):
            cmin = d[:, c, 0]
            for u in range(1, chunk):
                cmin = torch.fmin(cmin, d[:, c, u])
            better = cmin < best
            best, best_c = torch.where(better, cmin, best), torch.where(better, c, best_c)
        first = torch.zeros_like(best_c)
        for u in reversed(range(chunk)):
            first = torch.where(d[rows, best_c, u] == best, u, first)
        found = (best < float("inf")).numpy()
        key = ((best.view(torch.int32).numpy().astype(np.uint64) << np.uint64(32))
               | (s0 + best_c * chunk + first).numpy().astype(np.uint64))
        keys[found] = np.minimum(keys[found], key[found])
    none = keys == np.iinfo(np.uint64).max
    idx = np.where(none, 0, keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
    d2 = np.where(none, np.inf, (keys >> np.uint64(32)).astype(np.uint32).view(np.float32))
    return idx, d2.astype(np.float32)


KERNEL_CHUNK = 8  # map points per chunk of the kernel's argmin: csrc/nn_assoc.cu's U
UNIT_SHAPES = [(tnn.NN_SPAN, KERNEL_CHUNK), (tnn.NN_STRIPE_SPAN, KERNEL_CHUNK), (100, 3)]


@pytest.mark.parametrize("span,chunk", UNIT_SHAPES)
def test_dense_unit_merge_matches_plain_and_pallas(span, chunk):
    """The kernel's split into units and its order-free merge, emulated in
    torch (it checks the order of work, not the kernel), give the dense
    plain version's idx and d2 bit for bit on tie-heavy inputs whose M is a
    multiple of no unit, and the TPU kernel's in interpret mode."""
    B, N, M = 2, 150, 1301
    p, q = tie_heavy_case(18, B, N, M)
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    idx_p, d2_p = tnn.nn_argmin_plain(pt, qt)
    rng = np.random.default_rng(0)
    for b in range(B):
        idx, d2 = unit_merge(pt[b], qt[b], [(0, M)], span, chunk, rng)
        np.testing.assert_array_equal(idx, idx_p[b].numpy())
        np.testing.assert_array_equal(d2.view(np.int32), d2_p[b].numpy().view(np.int32))
    # Every distance is exact, so XLA's contraction changes no bit here.
    idx_j, d2_j = jnn.nn_argmin_pallas(jnp.asarray(p), jnp.asarray(q), tn=128, tm=512,
                                       interpret=True)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d2_p.numpy(), np.asarray(d2_j))
    assert (idx_p[:, 3:5] == 0).all() and torch.isinf(d2_p[:, 3:5]).all()


@pytest.mark.parametrize("span,chunk", UNIT_SHAPES)
def test_stripe_unit_merge_matches_plain_and_pallas(span, chunk):
    """The same for the sorted stripe: each live tile's run of map blocks
    cut into units, tiles with nblk = 0 searching nothing, a run that ends
    at the map's end, and the all-infinite rows in a live tile that starts
    past block 0."""
    B, N, M, tn, tm = 3, 256, 2048, 64, 256
    p, q = tie_heavy_case(19, B, N, M)
    rng = np.random.default_rng(20)
    start = rng.integers(0, M // tm, (B, N // tn)).astype(np.int32)
    nblk = rng.integers(1, 4, (B, N // tn)).astype(np.int32)
    start[:, 0], nblk[:, 0] = 2, 3  # rows 3 and 4 of every item: live, from block 2
    start[0, 1], nblk[0, 1] = M // tm - 1, 3  # runs past the map's end
    nblk[1, 2:] = 0
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    idx_p, d2_p = tnn.nn_stripe_plain(pt, qt, torch.from_numpy(start), torch.from_numpy(nblk), tm)
    for b in range(B):
        for t in np.nonzero(nblk[b])[0]:
            lo = int(start[b, t]) * tm
            rows = slice(t * tn, (t + 1) * tn)
            idx, d2 = unit_merge(pt[b, rows], qt[b], [(lo, min(M, lo + int(nblk[b, t]) * tm))],
                                 span, chunk, rng)
            np.testing.assert_array_equal(idx, idx_p[b, rows].numpy())
            np.testing.assert_array_equal(d2.view(np.int32), d2_p[b, rows].numpy().view(np.int32))
    idx_j, d2_j = jnn._nn_stripe_pallas(
        jnp.pad(jnp.asarray(p), ((0, 0), (0, 0), (0, 5))), jnn.coord_major(jnp.asarray(q)),
        jnp.asarray(start), tn=tn, tm=tm, nk=int(nblk.max()), interpret=True,
        nblk=jnp.asarray(nblk))
    live = np.repeat(nblk > 0, tn, axis=1)
    np.testing.assert_array_equal(idx_p.numpy()[live], np.asarray(idx_j)[live])
    np.testing.assert_array_equal(d2_p.numpy()[live], np.asarray(d2_j)[live])
    assert (idx_p[:, 3:5] == 0).all() and torch.isinf(d2_p[:, 3:5]).all()


@pytest.mark.parametrize("mode", ["dense", "stripe"])
def test_nn_wrappers_route_both_modes_to_their_entry(monkeypatch, mode):
    """On the card both launch modes reach mm_nn_argmin with their unit span
    and a scratch of their own for the packed minima: dense with no block
    arguments, NN_ROWS rows a tile and NN_SPAN map points a unit; the stripe
    with start_blk and nblk, its tiles' rows, tm and NN_STRIPE_SPAN."""
    calls = []

    class Library:
        @staticmethod
        def mm_nn_argmin(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(tnn, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    p, q = torch.zeros((2, 640, 3)), torch.zeros((2, 3000, 3))
    start = torch.tensor([[0, 1], [2, 0]], dtype=torch.int32)
    nblk = torch.tensor([[1, 0], [2, 1]], dtype=torch.int32)
    reset_launch_counts()
    if mode == "dense":
        idx, d2 = tnn.nn_argmin(p, q)
        blocks, shape = (None, None), (2, 640, 3000, tnn.NN_ROWS, 3000, tnn.NN_SPAN)
    else:
        idx, d2 = tnn.nn_stripe(p, q, start, nblk, 1000)
        blocks = (start.data_ptr(), nblk.data_ptr())
        shape = (2, 640, 3000, 320, 1000, tnn.NN_STRIPE_SPAN)
    (args,) = calls
    assert args[0] == p.data_ptr() and args[2:4] == blocks and args[4:10] == shape
    assert args[10:12] == (idx.data_ptr(), d2.data_ptr()) and args[13] == 7
    assert isinstance(args[12], int) and args[12] not in (args[0], args[1], *args[10:12])
    assert idx.shape == d2.shape == (2, 640) and idx.dtype == torch.int32
    assert launch_counts()["nn_argmin" if mode == "dense" else "nn_stripe"] == 1
    reset_launch_counts()


def test_stripe_sort_target_matches_jax():
    rng = np.random.default_rng(9)
    q = np.zeros((2, 300, 6), np.float32)
    q[0, :, 0] = rng.uniform(10, 15, 300)
    q[0, :, 1] = rng.uniform(20, 120, 300)  # item 0: y is the wide axis
    q[1, :, 0] = np.round(rng.uniform(-60, 60, 300))  # item 1: x, many equal keys
    q[1, :, 1] = rng.uniform(-5, 5, 300)
    q[..., 3:] = rng.standard_normal((2, 300, 3))
    q[:, -40:] = 1000.0
    got = tnn.stripe_sort_target(torch.from_numpy(q))
    want = jnn.stripe_sort_target(jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("refresh", [None, [True, False, True]])
def test_stripe_dispatcher_matches_dense_within_trim(refresh):
    rng = np.random.default_rng(10)
    B, N, M, trim = 3, 200, 2048, 3.0
    q = np.full((B, M, 3), 1000.0, np.float32)
    q[:, :1900, :2] = rng.uniform(-60, 60, (B, 1900, 2))
    q[:, :1900, 2] = 0.0
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    p = q_s[:, :1900:9][:, :N] + torch.from_numpy(rng.normal(0, 0.5, (B, N, 3)).astype(np.float32))
    order = torch.argsort(torch.where(use_x[:, None], p[..., 0], p[..., 1]), dim=1, stable=True)
    p = torch.gather(p, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    gate = None if refresh is None else torch.tensor(refresh)
    reset_launch_counts()
    idx, d2 = tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, trim, window=512,
                                             tn=64, refresh=gate)
    counts = launch_counts()  # CPU: no kernel runs
    assert set(counts) == {"conv3x3", "conv3x3_dx", "conv3x3_dk", "nn_stripe", "nn_argmin",
                           "conv3x3_nhcw", "conv3x3_nhcw_v2", "conv3x3_flat",
                           *(f"conv3x3_nhcw_run:{v}" for v in VARIANTS), "resize_bwd",
                           "bilinear_points_bwd"}
    assert not any(counts.values())
    idx_d, d2_d = tnn.nn_argmin(p, q_s)
    near = d2_d < trim ** 2
    assert near.float().mean() > 0.9
    if gate is not None:
        near &= gate[:, None]
    np.testing.assert_array_equal(idx[near].numpy(), idx_d[near].numpy())
    np.testing.assert_array_equal(d2[near].numpy(), d2_d[near].numpy())
    # The jax dispatcher agrees within trim too (its CPU path: window tiers).
    idx_j, _ = jnn.nn_argmin_stripe_presorted(
        jnp.asarray(p.numpy()), jnp.asarray(q_s.numpy()), jnp.asarray(key_s.numpy()),
        jnp.asarray(use_x.numpy()), trim, window=512, tn=64)
    np.testing.assert_array_equal(idx[near].numpy(), np.asarray(idx_j)[near.numpy()])


def test_stripe_blocks_cover_each_tile_span():
    p, q, *_ = stripe_case(seed=11, B=2, N=256, M=2048)
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    tn, tm, trim = 64, 256, 2.0
    start, nblk = tnn.stripe_blocks(torch.from_numpy(p), key_s, use_x, trim, tn, tm)
    key = p[..., 0].reshape(2, -1, tn)
    for b in range(2):
        for t in range(key.shape[1]):
            lo, hi = key[b, t].min() - trim, key[b, t].max() + trim
            need = np.nonzero((key_s[b].numpy() >= lo) & (key_s[b].numpy() < hi))[0]
            assert start[b, t] * tm <= need.min()
            assert need.max() < (start[b, t] + nblk[b, t]) * tm


def test_wrappers_refuse_devices_without_a_path():
    x = torch.empty((1, 1, 4, 4), device="meta")
    w = torch.empty((8, 1, 3, 3), device="meta")
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        conv3x3(x, w, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        use_kernel(torch.empty(1), torch.empty(1, device="meta"))


@contextlib.contextmanager
def no_host_reads():
    """Every Python-level read of a tensor's value (bool, int, float,
    index, item, tolist) raises inside the block: on the card each is a
    blocking copy to the host, and none can be captured in a CUDA graph."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor's value was read on the host")

    with contextlib.ExitStack() as stack:
        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist"):
            stack.enter_context(mock.patch.object(torch.Tensor, name, refuse))
        yield


@pytest.mark.parametrize("refresh", [None, [True, False, True]])
def test_stripe_dispatcher_over_budget_scans_the_whole_map(monkeypatch, refresh):
    """An item whose scan spans the whole map puts a tile over the block
    budget: the dispatcher then hands K4 block 0 and every block, with no
    read from the device (the reference's lax.cond as a select), and that
    full-range stripe scan gives the dense result bit for bit. Items the
    refresh gate skips search nothing."""
    rng = np.random.default_rng(12)
    B, N, M, trim, tn, window = 3, 256, 2048, 3.0, 64, 512
    q = np.full((B, M, 3), 1000.0, np.float32)
    q[:, :1900, :2] = rng.uniform(-60, 60, (B, 1900, 2))
    q[:, :1900, 2] = 0.0
    q[:, 700] = q[:, 300]  # an exact duplicate: the first occurrence must win
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    p = torch.from_numpy(rng.uniform(-60, 60, (B, N, 3)).astype(np.float32))
    p[..., 2] = 0.0  # unsorted: every tile spans the map
    gate = None if refresh is None else torch.tensor(refresh)
    calls = []

    def k4(p_, q3, start, nblk, tm, q4=None):
        calls.append(("nn_stripe", start.clone(), nblk.clone(), tm))
        return (torch.zeros(p_.shape[:2], dtype=torch.int32),
                torch.zeros(p_.shape[:2], dtype=torch.float32))

    def k1(*args):
        calls.append(("nn_argmin",))
        raise AssertionError("the stripe dispatcher took the dense kernel")

    monkeypatch.setattr(tnn, "nn_stripe", k4)
    monkeypatch.setattr(tnn, "nn_argmin", k1)
    with no_host_reads():
        tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, trim, window=window, tn=tn,
                                       refresh=gate)
    (name, start, nblk, tm), = calls
    live = torch.ones(B, dtype=torch.bool) if gate is None else gate
    assert tm == 512 and start.dtype == nblk.dtype == torch.int32
    assert (start == 0).all()
    assert (nblk[live] == M // tm).all() and (nblk[~live] == 0).all()
    idx, d2 = tnn.nn_stripe_plain(p, q_s, start, nblk, tm)
    idx_d, d2_d = tnn.nn_argmin_plain(p, q_s)
    rows = live[:, None].expand(B, N)
    np.testing.assert_array_equal(idx[rows].numpy(), idx_d[rows].numpy())
    assert torch.equal(d2[rows], d2_d[rows])  # the same bits
    idx_j, d2_j = jnn.nn_argmin_pallas(jnp.asarray(p.numpy()), jnp.asarray(q_s.numpy()),
                                       tn=128, tm=512, interpret=True)
    np.testing.assert_array_equal(idx[rows].numpy(), np.asarray(idx_j)[rows.numpy()])


def test_stripe_dispatcher_within_budget_keeps_each_tiles_blocks(monkeypatch):
    """A scan grouped by key keeps its tiles' own block ranges, again with
    no read from the device."""
    p, q, *_ = stripe_case(seed=13, B=2, N=256, M=2048)
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    p = torch.from_numpy(p)
    calls = []

    def k4(p_, q3, start, nblk, tm, q4=None):
        calls.append((start.clone(), nblk.clone(), tm))
        return (torch.zeros(p_.shape[:2], dtype=torch.int32),
                torch.zeros(p_.shape[:2], dtype=torch.float32))

    monkeypatch.setattr(tnn, "nn_stripe", k4)
    with no_host_reads():
        tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, 2.0, window=512, tn=64)
    (start, nblk, tm), = calls
    want_start, want_nblk = tnn.stripe_blocks(p, key_s, use_x, 2.0, 64, 512)
    assert torch.equal(start, want_start) and torch.equal(nblk, want_nblk)
    assert int(nblk.max()) <= 512 // tm + 1


def test_kernels_launch_on_their_inputs_device(monkeypatch):
    """A launch makes the inputs' card current and takes that card's
    current stream, whichever card is current before."""
    entered = []

    class Device:  # stands in for torch.cuda.device
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            entered.pop()

    calls = []

    class Library:
        @staticmethod
        def mm_nn_argmin(*args):
            calls.append((entered[-1] if entered else None, args))
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(
        cuda_stream=100 + torch.device(device).index))
    _build.launch("mm_nn_argmin", torch.device("cuda", 1), 7, 8)
    assert calls == [(torch.device("cuda", 1), (7, 8, 101))]
    assert entered == []


def test_use_kernel_refuses_cuda_inputs_on_two_cards():
    a, b = (SimpleNamespace(device=torch.device("cuda", i)) for i in (0, 1))
    with pytest.raises(ValueError, match="one CUDA device"):
        use_kernel(a, b)
    assert use_kernel(a, a)
