"""The port's conv-probe path vs the JAX package's probes P1–P4.

The same numpy inputs go through each Pallas probe of
``benchmarks/probe_pallas_conv*.py`` (P1 with ``interpret=True``, P2 and P3
under ``force_tpu_interpret_mode()``, P4 interprets by itself off the TPU)
and through its counterpart in ``ops/kernels/conv_probes.py``, which runs
its plain version on the CPU. ``test_torch_gpu.py`` holds the CUDA kernels
against those plain versions on the card.
"""
from __future__ import annotations

import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mm_masking_tpu_torch.benchmarks import probe_conv
from mm_masking_tpu_torch.ops.kernels import conv_probes as cp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probes():
    """The four probe modules. Importing P2–P4 points JAX's persistent
    compilation cache at the checkout for the whole process; the settings
    are put back after the import."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        mods = [importlib.import_module(f"benchmarks.probe_pallas_conv{s}")
                for s in ("", "2", "3", "4")]
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return types.SimpleNamespace(p1=mods[0], p2=mods[1], p3=mods[2], p4=mods[3])


def data(seed, B, H, W, Ci, Co):
    """x NCHW and k HWIO as the probes draw them (f32 numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Ci, H, W)).astype(np.float32)
    k = (rng.standard_normal((3, 3, Ci, Co)) * 0.1).astype(np.float32)
    return x, k


def both(x, k, dtype):
    """(jax x, jax k, torch x, torch k), rounded to ``dtype`` alike."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                            torch.float32)
    return (jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt),
            torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt))


def assert_close(got: torch.Tensor, want, dtype: str):
    """f32: the sums run in another order (measured <= 1.9e-6 of max|y|);
    bf16: one rounding of the output to 8 bits."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * scale)


CASES_P1 = [(2, 32, 256, 8, 8, False), (1, 16, 128, 16, 8, False), (2, 24, 128, 8, 16, False),
            (1, 8, 256, 3, 8, False), (2, 32, 256, 8, 8, True)]


@pytest.mark.parametrize("B,H,W,Ci,Co,relu,dtype",
                         [(*c, "float32") for c in CASES_P1] + [(*CASES_P1[0], "bfloat16")]
                         + [(*CASES_P1[3], "bfloat16"), (2, 16, 128, 1, 8, False, "bfloat16")])
def test_p1_matches_probe(probes, B, H, W, Ci, Co, relu, dtype):
    x, k = data(0, B, H, W, Ci, Co)
    jx, jk, tx, tk = both(x, k, dtype)
    want = probes.p1.conv3x3_nhcw_pallas(jnp.transpose(jx, (0, 2, 1, 3)), jk, TH=8,
                                          relu=relu, interpret=True)
    got = cp.conv3x3_nhcw(tx.transpose(1, 2).contiguous(), tk, TH=8, relu=relu)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("variant", ["full", "row2", "tap-dots", "asm-only", "dot-only"])
@pytest.mark.parametrize("B,H,W,Ci,Co,TH", [(1, 16, 128, 8, 8, 8), (1, 32, 128, 16, 16, 16)])
def test_p2_variants_match_probe(probes, B, H, W, Ci, Co, TH, variant):
    x, k = data(1, B, H, W, Ci, Co)
    xp = np.pad(x.transpose(0, 2, 1, 3), ((0, 0), (1, 1), (0, 0), (0, 0)))
    kmat = np.transpose(k, (3, 0, 1, 2)).reshape(Co, 9 * Ci)
    with pltpu.force_tpu_interpret_mode():
        want = probes.p2.run(variant, jnp.asarray(xp), jnp.asarray(kmat), TH, Ci, Co, W)
    got = cp.conv3x3_nhcw_run(variant, torch.from_numpy(xp), torch.from_numpy(kmat), TH)
    if variant == "dot-only":  # scratch that was never written: only shape and type
        assert tuple(got.shape) == want.shape == (B, H, Co, W)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
    elif variant == "asm-only":  # a copy of the im2col stack: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert_close(got, want, "float32")


@pytest.mark.parametrize("variant", ["full", "row2", "tap-dots", "asm-only"])
def test_p2_bf16_matches_probe(probes, variant):
    """Every P2 variant with a defined value, in bfloat16: within 1e-2 of
    max |y| (one rounding of the output to 8 bits); asm-only, a copy, exact."""
    B, H, W, Ci, Co, TH = 1, 32, 128, 16, 16, 16
    x, k = data(2, B, H, W, Ci, Co)
    xp = np.pad(x.transpose(0, 2, 1, 3), ((0, 0), (1, 1), (0, 0), (0, 0)))
    kmat = np.transpose(k, (3, 0, 1, 2)).reshape(Co, 9 * Ci)
    jxp, jkm, txp, tkm = both(xp, kmat, "bfloat16")
    with pltpu.force_tpu_interpret_mode():
        want = probes.p2.run(variant, jxp, jkm, TH, Ci, Co, W)
    got = cp.conv3x3_nhcw_run(variant, txp, tkm, TH)
    if variant == "asm-only":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        assert_close(got, want, "bfloat16")


@pytest.mark.parametrize("B,H,W,Ci,Co,TH,dtype", [
    (2, 32, 256, 8, 8, 8, "float32"), (1, 32, 128, 16, 16, 16, "float32"),
    (2, 24, 128, 1, 8, 8, "float32"), (1, 32, 128, 16, 16, 16, "bfloat16")])
def test_p3_matches_probe(probes, B, H, W, Ci, Co, TH, dtype):
    x, k = data(3, B, H, W, Ci, Co)
    jx, jk, tx, tk = both(x, k, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = probes.p3.conv3x3_nhcw_v2(jnp.transpose(jx, (0, 2, 1, 3)), jk, TH=TH)
    got = cp.conv3x3_nhcw_v2(tx.transpose(1, 2).contiguous(), tk, TH=TH)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("B,H,W,Ci,Co,TH,ndot,dtype", [
    (2, 32, 256, 8, 8, 8, 1, "float32"), (1, 32, 128, 16, 16, 16, 1, "float32"),
    (1, 32, 128, 16, 16, 16, 3, "float32"), (2, 24, 128, 1, 8, 8, 1, "float32"),
    (1, 32, 128, 16, 16, 16, 3, "bfloat16"), (1, 32, 128, 16, 16, 16, 1, "bfloat16"),
    (2, 24, 128, 1, 8, 8, 1, "bfloat16")])
def test_p4_matches_probe(probes, B, H, W, Ci, Co, TH, ndot, dtype):
    x, k = data(4, B, H, W, Ci, Co)
    jx, jk, tx, tk = both(x, k, dtype)
    want = probes.p4.conv3x3_flat(jx, jk, TH=TH, ndot=ndot)
    assert_close(cp.conv3x3_flat(tx, tk, TH=TH, ndot=ndot), want, dtype)


def test_kmat_from_hwio_matches_the_probes_transpose():
    _, k = data(5, 1, 8, 8, 3, 5)
    want = jnp.transpose(jnp.asarray(k), (3, 0, 1, 2)).reshape(5, 27)
    got = cp.kmat_from_hwio(torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probes_refuse_what_the_probes_refuse():
    x = torch.zeros(1, 12, 4, 32)  # NHCW, H = 12
    k = torch.zeros(3, 3, 4, 8)
    xp = torch.zeros(1, 14, 4, 32)
    kmat = cp.kmat_from_hwio(k)
    with pytest.raises(ValueError, match="TH = 8"):
        cp.conv3x3_nhcw(x, k, TH=8)
    with pytest.raises(ValueError, match="TH = 8"):
        cp.conv3x3_nhcw_v2(x, k, TH=8)
    with pytest.raises(ValueError, match="TH = 8"):
        cp.conv3x3_flat(x.transpose(1, 2), k, TH=8)
    with pytest.raises(ValueError, match="TH = 8"):
        cp.conv3x3_nhcw_run("full", xp, kmat, TH=8)
    with pytest.raises(ValueError, match="ndot"):
        cp.conv3x3_flat(x.transpose(1, 2), k, TH=4, ndot=2)
    with pytest.raises(ValueError, match="variant"):
        cp.conv3x3_nhcw_run("dots", xp, kmat, TH=4)
    with pytest.raises(ValueError, match="even"):
        cp.conv3x3_nhcw_run("row2", xp, kmat, TH=3)
    with pytest.raises(ValueError, match="asm-only"):
        cp.conv3x3_nhcw_run("asm-only", xp[:, :, :1], torch.zeros(16, 9), TH=4)
    with pytest.raises(ValueError, match="HWIO"):
        cp.conv3x3_nhcw(x, k[:, :, :3], TH=4)


def test_p3_bf16_refuses_a_float32_k(monkeypatch):
    """P3's bfloat16 kernel multiplies bfloat16 values: a bfloat16 x with a
    float32 k (which the probe promotes to a float32 product) is refused
    before anything is built or launched, rather than rounded; ring=False
    exists for the bfloat16 kernel only."""
    monkeypatch.setattr(cp, "use_kernel", lambda *t: True)  # the card's branch

    def no_library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cp, "library", no_library)
    x = torch.zeros(1, 16, 4, 32)
    k = torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="bfloat16 k"):
        cp.conv3x3_nhcw_v2(x.bfloat16(), k, TH=8)
    with pytest.raises(ValueError, match="ring=False"):
        cp.conv3x3_nhcw_v2(x, k, TH=8, ring=False)


def test_p1_bf16_refuses_a_float32_k(monkeypatch):
    """P1's bfloat16 kernel (and P2's variants, on the tensor cores too)
    multiplies bfloat16 values: a bfloat16 x with a float32 k is refused
    before anything is built or launched, rather than rounded."""
    monkeypatch.setattr(cp, "use_kernel", lambda *t: True)  # the card's branch

    def no_library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cp, "library", no_library)
    x = torch.zeros(1, 16, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="bfloat16 k"):
        cp.conv3x3_nhcw(x, k, TH=8)
    xp = torch.zeros(1, 18, 4, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 k"):
        cp.conv3x3_nhcw_run("full", xp, cp.kmat_from_hwio(k), TH=8)
    with pytest.raises(ValueError, match="row2: the bfloat16 kernel takes a bfloat16 k"):
        cp.conv3x3_nhcw_run("row2", xp, cp.kmat_from_hwio(k), TH=8)


@pytest.mark.parametrize("probe", list(cp.VARIANTS) + ["P4 ndot1", "P4 ndot3"])
def test_p2_and_p4_bf16_refuse_a_float32_k(monkeypatch, probe):
    """Every P2 variant and P4 in bfloat16 run on the tensor cores, whose
    products are of bfloat16 values: a float32 k (kmat) with a bfloat16 x
    raises before anything is built or launched."""
    monkeypatch.setattr(cp, "use_kernel", lambda *t: True)  # the card's branch

    def no_library():
        raise AssertionError("the wrapper reached the kernel library")

    monkeypatch.setattr(cp, "library", no_library)
    k = torch.zeros(3, 3, 4, 4)
    with pytest.raises(ValueError, match="the bfloat16 kernel takes a bfloat16 k, got "
                                         "torch.float32"):
        if probe.startswith("P4"):
            x = torch.zeros(1, 4, 16, 32, dtype=torch.bfloat16)
            cp.conv3x3_flat(x, k, TH=8, ndot=int(probe[-1]))
        else:
            xp = torch.zeros(1, 18, 4, 32, dtype=torch.bfloat16)
            cp.conv3x3_nhcw_run(probe, xp, cp.kmat_from_hwio(k), TH=8)


@pytest.mark.parametrize("ci,co", [(1, 8), (3, 5), (16, 16), (32, 32)])
def test_p1_bf16_weight_packing(ci, co):
    """The weights P1's bfloat16 kernel reads: kmat (Co, 9·Ci) with K as a
    whole in the probes' k order (di·3 + dj)·Ci + ci, zero-padded to a
    multiple of 16 (Ci = 1: one k16 step) and Co to a multiple of 8."""
    _, k = data(8, 1, 8, 8, ci, co)
    kmat = cp.kmat_from_hwio(torch.from_numpy(k).bfloat16())
    packed = cp.pack_kmat_bf16(kmat)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (-(-co // 8) * 8, -(-9 * ci // 16) * 16)
    assert torch.equal(packed[:co, :9 * ci], kmat)
    assert not packed[co:].any() and not packed[:, 9 * ci:].any()
    assert packed[:co, (1 * 3 + 2) * ci].equal(torch.from_numpy(k[1, 2, 0]).bfloat16())


def test_p1_bf16_tiles_fit_the_shared_memory():
    """Every P1 check, full-size and timing shape, and P2's full at its
    timing shapes, takes a column tile of P1's bfloat16 kernel (the layout's
    sum, which the source reports; ``test_torch_gpu.py`` holds the two
    equal): two blocks an SM at each timing shape, as wide a tile as that
    allows; none for a tile that is no whole number of 16-pixel m-tiles."""
    shapes = (probe_conv.CHECKS["P1"] + probe_conv.FULL["P1"] + probe_conv.TIMES["P1"]
              + [c for c in probe_conv.TIMES["P2"] if c.variant == "full"])
    for c in shapes:
        wt = cp._w_tile(c.W, lambda t: cp.mma_smem_bytes(c.Ci, c.Co, c.TH, t), c.label)
        assert wt in (16, 32, 64, 128) and cp.mma_smem_bytes(c.Ci, c.Co, c.TH, wt) <= cp.SMEM_TWO
    assert cp.mma_smem_bytes(16, 16, 8, 8) == 2**64 - 1
    # B16 640², 16 -> 16: 64 columns at TH 8, 32 at TH 16.
    assert cp._w_tile(640, lambda t: cp.mma_smem_bytes(16, 16, 8, t), "x") == 64
    assert cp._w_tile(640, lambda t: cp.mma_smem_bytes(16, 16, 16, t), "x") == 32


def test_p2_p4_bf16_tiles_fit_the_shared_memory():
    """Every P2 variant's and P4's bfloat16 check, full-size and timing shape
    takes a tile of its tensor-core kernel (the layouts' sums, which the
    sources report; ``test_torch_gpu.py`` holds the two equal), two blocks
    an SM at each timing shape: row2's stack buffers hold two rows, tap-dots
    is P3's halo GEMM without the ring, P4 the same with the ring over
    sub-tiles of ``flat_rows(TH)`` rows."""
    def fits(c, smem):
        wt = cp._w_tile(c.W, smem, c.label)
        assert wt in (16, 32, 64, 128), c.label
        return wt, smem(wt)

    p2 = probe_conv.CHECKS["P2"] + probe_conv.FULL["P2"] + probe_conv.TIMES["P2"]
    for c in p2:
        wt, nbytes = fits(c, lambda t: cp.nhcw_bf16_smem_bytes(c.variant, c.Ci, c.Co, c.TH, t))
        assert nbytes <= cp.SMEM_TWO, c.label
    p4 = probe_conv.CHECKS["P4"] + probe_conv.FULL["P4"] + probe_conv.TIMES["P4"]
    for c in p4:
        rows = cp.flat_rows(c.TH)
        assert c.TH % rows == 0 and rows <= 16
        wt, nbytes = fits(c, lambda t: cp.halo_smem_bytes(c.Ci, c.Co, rows, t, ring=True))
        assert nbytes <= cp.SMEM_TWO, c.label
    # B16 640², 16 -> 16: row2 takes 32 columns at TH 8 (full 64), tap-dots 64
    # at TH 8 and 32 at TH 16, P4 64 in sub-tiles of 8 rows at every TH.
    assert cp._w_tile(640, lambda t: cp.nhcw_bf16_smem_bytes("row2", 16, 16, 8, t), "x") == 32
    assert cp._w_tile(640, lambda t: cp.nhcw_bf16_smem_bytes("full", 16, 16, 8, t), "x") == 64
    assert cp._w_tile(640, lambda t: cp.nhcw_bf16_smem_bytes("tap-dots", 16, 16, 8, t),
                      "x") == 64
    assert cp._w_tile(640, lambda t: cp.nhcw_bf16_smem_bytes("tap-dots", 16, 16, 16, t),
                      "x") == 32
    for th in (16, 32, 64):
        rows = cp.flat_rows(th)
        assert cp._w_tile(640, lambda t: cp.halo_smem_bytes(16, 16, rows, t, True), "x") == 64
    # The sums' parts: row2 adds one row to each of the two stack buffers;
    # the ring adds one slab slot.
    ku = 19  # 9·16 = 144 → 9 k16 steps, 18 units, made odd
    assert (cp.nhcw_bf16_smem_bytes("row2", 16, 16, 8, 32)
            - cp.nhcw_bf16_smem_bytes("full", 16, 16, 8, 32)) == 2 * 32 * ku * 16
    assert (cp.halo_smem_bytes(16, 16, 8, 64, True) - cp.halo_smem_bytes(16, 16, 8, 64, False)
            == 10 * 16 * 80 * 2)
    assert cp.halo_smem_bytes(16, 16, 8, 8, True) == 2**64 - 1


@pytest.mark.parametrize("ci,co", [(8, 8), (16, 16), (16, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_asm_only_library_call_is_its_function(ci, co, dtype):
    """asm-only's yardstick (``probe_conv.library_call``): where Co ≤ Ci the
    stack's first Co rows are tap (0, 0), so one ``F.pad`` of the padded x
    gives them, equal bit for bit to the plain version at P2's check and
    timing channel counts; dot-only has no such call."""
    case = probe_conv.Case("P2", 2, 16, 40, ci, co, 8, variant="asm-only")
    x, k = probe_conv.inputs(case, dtype, torch.device("cpu"))
    xp = torch.nn.functional.pad(x.transpose(1, 2).contiguous(), (0, 0, 0, 0, 1, 1))
    want = cp.conv3x3_nhcw_run_plain("asm-only", xp, cp.kmat_from_hwio(k))
    got = probe_conv.library_call(case, x, k)()
    assert got.dtype == want.dtype and torch.equal(got, want)
    dot = probe_conv.Case("P2", 2, 16, 40, ci, co, 8, variant="dot-only")
    assert probe_conv.library_call(dot, x, k) is None
    wide = probe_conv.Case("P2", 2, 16, 40, ci, ci + 1, 8, variant="asm-only")
    assert probe_conv.library_call(wide, x, k) is None


@pytest.mark.parametrize("ci,co", [(1, 8), (3, 5), (16, 16), (20, 12)])
def test_tap_dots_bf16_weight_packing(ci, co):
    """tap-dots in bfloat16 runs P3's halo GEMM on P2's kmat: packed from
    kmat (Co, 9·Ci), its weights equal P3's packing of the HWIO k that
    kmat flattens."""
    _, k = data(9, 1, 8, 8, ci, co)
    kt = torch.from_numpy(k).bfloat16()
    got = cp.pack_kmat_chunks_bf16(cp.kmat_from_hwio(kt))
    assert torch.equal(got, cp.pack_weight_bf16(kt.permute(3, 2, 0, 1), t=16))


@pytest.mark.parametrize("ci,co", [(3, 5), (16, 16), (20, 12)])
def test_p3_bf16_weight_packing(ci, co):
    """The packing P3's bfloat16 kernel reads: chunks of 16 input channels,
    element [c, 3·di + dj, o, j] = k[di, dj, 16·c + j, o], zero past Ci and
    Co (Co rounded up to 8)."""
    _, k = data(7, 1, 8, 8, ci, co)
    kt = torch.from_numpy(k).bfloat16()
    packed = cp.pack_weight_bf16(kt.permute(3, 2, 0, 1), t=16)
    n = -(-ci // 16)
    assert packed.dtype == torch.bfloat16 and packed.shape == (n, 9, -(-co // 8) * 8, 16)
    want = torch.zeros(n * 16, 9, packed.shape[2], dtype=torch.bfloat16)
    want[:ci, :, :co] = kt.reshape(9, ci, co).transpose(0, 1)
    assert torch.equal(packed, want.reshape(n, 16, 9, -1).permute(0, 2, 3, 1))


def test_tiles_fit_the_shared_memory():
    """The host's tile choice, on stand-in block sizes (the CUDA sources
    report the real ones; ``test_torch_gpu.py`` holds those): the widest
    tile that fits two blocks per SM, before a wider one that fits only
    one; one block where only that fits; a clear error where nothing does
    (then no launch)."""
    assert cp.pick_size(cp.W_TILES, lambda t: 3000 * t, "x") == 32
    assert cp.pick_size(cp.W_TILES, lambda t: 10_000 * t, "x") == 8
    wt = cp.pick_size(cp.W_TILES[:-1], lambda t: 12_000 * t, "x")
    assert wt == 16 and cp.SMEM_TWO < 12_000 * wt <= cp.SMEM_LIMIT
    with pytest.raises(ValueError, match="P1 64->64: a tile of 8 needs .* shared memory"):
        cp.pick_size(cp.W_TILES, lambda t: cp.SMEM_LIMIT + t, "P1 64->64")


def test_probe_path_runs_on_cpu(capsys):
    """The probe CLI on the CPU: every check shape through the plain
    versions, held against F.conv2d; no time claimed."""
    out = probe_conv.main(["--probe", "all", "--device", "cpu"])
    n_checks = sum(len(v) for v in probe_conv.CHECKS.values())
    assert len(out["checks"]) == n_checks and out["times"] == []
    for rec in out["checks"]:
        assert rec["rel_conv"] is None or rec["rel_conv"] <= 1e-5, rec
    text = capsys.readouterr().out
    assert text.count("not measured") == sum(len(v) for v in probe_conv.TIMES.values())


def test_probe_path_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        probe_conv.main(["--probe", "1"])
