"""The conv-probe kernels P1–P4 and their plain PyTorch versions.

The JAX package's ``benchmarks/probe_pallas_conv*.py`` study four ways to
lay out a 3×3 SAME conv (no bias, optional ReLU) for a matrix unit. Each is
a CUDA kernel here:

- P1 :func:`conv3x3_nhcw` (``probe_pallas_conv.py:105``) and P2
  :func:`conv3x3_nhcw_run` (``probe_pallas_conv2.py:103``, P1's body in five
  variants) → ``csrc/conv_probe_nhcw.cu``: one staged halo slab, an explicit
  im2col stack, one contraction per row; in bfloat16 every variant runs on
  the tensor cores, P2's ``tap-dots`` as P3's implicit GEMM;
- P3 :func:`conv3x3_nhcw_v2` (``probe_pallas_conv3.py:80``) →
  ``csrc/conv_probe_halo.cu``: the same, the next tile's halo prefetched
  through a two-stage ring; in bfloat16 an implicit GEMM on the tensor
  cores over that halo, with no im2col stack (``csrc/conv_probe_gemm.cuh``);
- P4 :func:`conv3x3_flat` (``probe_pallas_conv4.py:104``) →
  ``csrc/conv_probe_flat.cu``: the taps as lane shifts of a flat NCHW slab;
  in bfloat16 P3's implicit GEMM reading and writing NCHW.

Every bfloat16 kernel multiplies bfloat16 values and takes a bfloat16 k or
kmat only: a float32 one raises ValueError before anything is built, rather
than being rounded.

The public functions keep the probes' layouts: NHCW (B, H, Ci, W) for P1 and
P3, a pre-padded NHCW (B, H + 2, Ci, W) with ``kmat`` (Co, 9·Ci) for P2, and
NCHW for P4; every weight is HWIO (3, 3, Ci, Co). The probes pad Ci to a
sublane tile of 8 or 16, a TPU artifact that changes no output; the port
does not. Inputs are float32 or bfloat16; the sums are float32, over
``kmat``'s columns (di·3 + dj)·Ci + ci, and the output has x's type.

As every wrapper of this package, each dispatches on its input's device: a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. The launch counters are ``conv3x3_nhcw.launches``,
``conv3x3_nhcw_v2.launches``, ``conv3x3_flat.launches`` and one for each P2
variant in :data:`RUN_COUNTERS`.
"""
from __future__ import annotations

import functools
import types

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import SMEM_LIMIT, launch, library, use_kernel
from mm_masking_tpu_torch.ops.kernels.conv2d import pack_weight_bf16

# P2's variants, in the order of the Variant enum of csrc/conv_probe_nhcw.cu.
VARIANTS = ("full", "asm-only", "dot-only", "row2", "tap-dots")
RUN_COUNTERS = {v: types.SimpleNamespace(launches=0) for v in VARIANTS}

SMEM_TWO = 115_712  # at most this much per block lets two blocks share an SM
W_TILES = (128, 64, 32, 16, 8)  # column tiles of the NHCW kernels, widest first
LANE_CHUNKS = (4096, 2048, 1024, 512, 256, 128, 64, 32)  # P4's lane chunks, float32
_DTYPES = (torch.float32, torch.bfloat16)


def kmat_from_hwio(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) → (Co, 9·Ci), column (di·3 + dj)·Ci + ci: the probes'
    flattening (``probe_pallas_conv.py:102``)."""
    return k.permute(3, 0, 1, 2).reshape(k.shape[3], 9 * k.shape[2])


# ---------------------------------------------------------------- plain versions


def _im2col_nhcw(xp: torch.Tensor) -> torch.Tensor:
    """x padded by one zero row above and below (B, H + 2, Ci, W) → the
    im2col stack (B, H, 9·Ci, W): row (di·3 + dj)·Ci + ci at (h, w) is
    xp[h + di, ci, w + dj − 1], zero outside the row."""
    H, W = xp.shape[1] - 2, xp.shape[3]
    xw = F.pad(xp, (1, 1))
    return torch.cat([xw[:, di:di + H, :, dj:dj + W] for di in range(3) for dj in range(3)],
                     dim=2)


def _contract(kmat: torch.Tensor, x9: torch.Tensor, relu: bool = False,
              ndot: int = 1) -> torch.Tensor:
    """y[b, h, o, w] = Σ_k kmat[o, k]·x9[b, h, k, w] in float32; ndot = 3 adds
    three contractions over consecutive thirds of k, in order."""
    parts = [torch.einsum("ok,bhkw->bhow", a, b)
             for a, b in zip(kmat.float().chunk(ndot, dim=1), x9.float().chunk(ndot, dim=2))]
    y = sum(parts[1:], parts[0])
    return torch.relu(y) if relu else y


def conv3x3_nhcw_plain(x: torch.Tensor, k: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """Plain version of P1 and P3: x (B, H, Ci, W), k HWIO → (B, H, Co, W)."""
    x9 = _im2col_nhcw(F.pad(x, (0, 0, 0, 0, 1, 1)))
    return _contract(kmat_from_hwio(k), x9, relu).to(x.dtype).contiguous()


def conv3x3_nhcw_run_plain(variant: str, x_padded: torch.Tensor,
                           kmat: torch.Tensor) -> torch.Tensor:
    """Plain version of P2's variants."""
    if variant == "dot-only":  # a contraction over scratch nobody wrote
        B, Hp, Ci, W = x_padded.shape
        x9 = torch.empty((B, Hp - 2, 9 * Ci, W), dtype=x_padded.dtype, device=x_padded.device)
        return _contract(kmat, x9).to(x_padded.dtype).contiguous()
    x9 = _im2col_nhcw(x_padded)
    if variant == "asm-only":
        return x9[:, :, :kmat.shape[0]].contiguous()
    return _contract(kmat, x9).to(x_padded.dtype).contiguous()  # full, row2, tap-dots


def conv3x3_flat_plain(x: torch.Tensor, k: torch.Tensor, ndot: int = 1,
                       relu: bool = False) -> torch.Tensor:
    """Plain version of P4: x (B, Ci, H, W), k HWIO → (B, Co, H, W)."""
    x9 = _im2col_nhcw(F.pad(x.transpose(1, 2), (0, 0, 0, 0, 1, 1)))
    y = _contract(kmat_from_hwio(k), x9, relu, ndot)
    return y.to(x.dtype).transpose(1, 2).contiguous()


# ------------------------------------------------------------ shared-memory sizing


def pick_size(sizes, smem_of, what: str) -> int:
    """The largest of ``sizes`` (widest first) whose block fits two to an
    SM, else the largest that fits one block at all; ValueError if none
    does, so that nothing is launched that the card would refuse. Each
    source owns its block's layout and reports its bytes
    (``mm_probe_*_smem_bytes``) as ``smem_of``."""
    fits = [s for s in sizes if smem_of(s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"{what}: a tile of {sizes[-1]} needs {smem_of(sizes[-1])} bytes of "
                         f"shared memory, more than the {SMEM_LIMIT} a block may have")
    return next((s for s in fits if smem_of(s) <= SMEM_TWO), fits[0])


def tiles_per_block(n_tiles: int, other_blocks: int) -> int:
    """Row tiles each P3 block walks through its ring: up to 8, while the
    grid keeps about four blocks for each of the H100's 132 SMs."""
    return max(1, min(8, n_tiles, n_tiles * other_blocks // 528))


# ------------------------------------------------------------------- wrappers


def _check_rows(H: int, TH: int) -> None:
    if TH < 1 or H % TH:
        raise ValueError(f"H = {H} is not a multiple of the row tile TH = {TH}")


def _check_hwio(k: torch.Tensor, Ci: int) -> None:
    if k.ndim != 4 or tuple(k.shape[:3]) != (3, 3, Ci):
        raise ValueError(f"k must be HWIO (3, 3, {Ci}, Co), got {tuple(k.shape)}")


def _kernel_inputs(x: torch.Tensor, kmat: torch.Tensor):
    """x contiguous, kmat as float32, and whether x's rows take 16-byte copies."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"the conv-probe kernels take float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    vec = x.shape[-1] % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    return x, kmat.float().contiguous(), int(vec)


def _w_tile(W: int, smem_of, what: str) -> int:
    return pick_size([t for t in W_TILES if t <= -(-W // 8) * 8], smem_of, what)


def pack_kmat_bf16(kmat: torch.Tensor) -> torch.Tensor:
    """kmat (Co, 9·Ci) bfloat16 → the weights of P1's bfloat16 kernel: kmat
    zero-padded to (Co rounded up to 8, 9·Ci rounded up to 16), K as a whole
    in the probes' k order (no chunks of channels)."""
    Co, K = kmat.shape
    return F.pad(kmat, (0, -K % 16, 0, -Co % 8)).contiguous()


def pack_kmat_chunks_bf16(kmat: torch.Tensor) -> torch.Tensor:
    """kmat (Co, 9·Ci) → the weights of the halo GEMM (P3's, which tap-dots
    runs): kmat read as OIHW, packed by ``pack_weight_bf16`` in chunks of 16
    input channels."""
    Co, K = kmat.shape
    return pack_weight_bf16(kmat.reshape(Co, 3, 3, K // 9).permute(0, 3, 1, 2), t=16)


def _n_tiles(Co: int) -> int:
    return 1 if Co <= 8 else 2 if Co <= 16 else 4 if Co <= 32 else 8


def mma_smem_bytes(Ci: int, Co: int, TH: int, Wt: int, rows: int = 1) -> int:
    """Shared bytes of one block of P1's bfloat16 tensor-core kernel, which
    P2's full, asm-only and dot-only share and row2 takes with ``rows`` = 2
    (the layout ``SmemMma`` of ``csrc/conv_probe_nhcw.cu``, which reports the
    same through ``mm_probe_nhcw_smem_bytes``; a sum for checks without the
    card): the weights and each pixel of the stack K = 9·Ci rounded up to 16
    and made an odd number of 16-byte units, the k offsets, the slab of
    TH + 2 rows, two stack buffers of ``rows`` rows and the output tile;
    SIZE_MAX, 2⁶⁴ − 1, for a Wt it does not take."""
    if Wt not in (16, 32, 64, 128):
        return 2**64 - 1
    ku = -(-9 * Ci // 16) * 2 + 1
    nt = _n_tiles(Co)
    return (8 * nt * ku * 16 + (ku - 1) * 8 * 4 + (TH + 2) * Ci * (Wt + 16) * 2
            + 2 * rows * Wt * ku * 16 + TH * 8 * nt * (Wt + 8) * 2)


def halo_smem_bytes(Ci: int, Co: int, TH: int, Wt: int, ring: bool) -> int:
    """Shared bytes of one block of the bfloat16 implicit GEMM that P3,
    P2's tap-dots (without the ring) and P4 (with it) share (the layout
    ``SmemHalo`` of ``csrc/conv_probe_gemm.cuh``, which each source reports;
    a sum for checks without the card): the weights, 9 taps × 8·nt channels
    × 48 bytes a chunk of 16 input channels; the halo, (TH + 2) × (Wt + 2)
    pixels of 2·chunks + 1 16-byte units; the output tile; one or two slab
    slots of (TH + 2)·Ci rows of Wt + 16 values; SIZE_MAX for a Wt it does
    not take."""
    if Wt not in (16, 32, 64, 128):
        return 2**64 - 1
    chunks, nt = -(-Ci // 16), _n_tiles(Co)
    return (chunks * 9 * nt * 8 * 48 + (TH + 2) * (Wt + 2) * (2 * chunks + 1) * 16
            + TH * nt * 8 * (Wt + 8) * 2 + (2 if ring else 1) * (TH + 2) * Ci * (Wt + 16) * 2)


def nhcw_bf16_smem_bytes(variant: str, Ci: int, Co: int, TH: int, Wt: int) -> int:
    """Shared bytes of one block of P2's ``variant`` in bfloat16 (as
    ``mm_probe_nhcw_smem_bytes`` reports them): the stack's, the halo
    GEMM's without the ring for tap-dots."""
    if variant == "tap-dots":
        return halo_smem_bytes(Ci, Co, TH, Wt, ring=False)
    return mma_smem_bytes(Ci, Co, TH, Wt, rows=2 if variant == "row2" else 1)


def flat_rows(TH: int) -> int:
    """Rows of the sub-tiles in which a block of P4's bfloat16 kernel walks
    its TH rows through the ring: 8, so that two blocks' halos of 64 columns
    fit an SM and, from TH 16 on, a block has a sub-tile to prefetch; TH
    itself where 8 does not divide it."""
    return 8 if TH % 8 == 0 else TH


@functools.lru_cache(maxsize=None)
def _nhcw_tile(v: int, Ci: int, Co: int, TH: int, W: int, e: int) -> int:
    """The column tile of P1's body as variant ``v`` (by the source's own
    bytes, ``mm_probe_nhcw_smem_bytes``)."""
    dtype = "bf16" if e == 2 else "f32"
    return _w_tile(W, lambda t: library().mm_probe_nhcw_smem_bytes(v, Ci, Co, TH, t, e),
                   f"conv probe {VARIANTS[v]} Ci={Ci} Co={Co} TH={TH} {dtype}")


def _refuse_float32_k(what: str, k: torch.Tensor) -> None:
    """The bfloat16 kernels' products are of bfloat16 values: a float32 k
    would be rounded, so it is refused before anything is built."""
    if k.dtype != torch.bfloat16:
        raise ValueError(f"conv probe {what}: the bfloat16 kernel takes a bfloat16 k, got "
                         f"{k.dtype} (it would be rounded to bfloat16)")


def _launch_mma(x: torch.Tensor, kmat: torch.Tensor, TH: int, relu: bool, padded: bool,
                variant: str = "full") -> torch.Tensor:
    """P1's body as P2's ``variant`` in bfloat16 on the tensor cores, on x
    (B, H, Ci, W) or, ``padded``, on x with a zero row above and below
    (B, H + 2, Ci, W); a bfloat16 kmat only."""
    _refuse_float32_k(variant, kmat)
    x = x.contiguous()
    B, Hx, Ci, W = x.shape
    H, Co = Hx - 2 * padded, kmat.shape[0]
    vec = W % 8 == 0 and x.data_ptr() % 16 == 0
    v = VARIANTS.index(variant)
    wt = _nhcw_tile(v, Ci, Co, TH, W, 2)
    w = pack_kmat_chunks_bf16(kmat) if variant == "tap-dots" else pack_kmat_bf16(kmat)
    y = torch.empty((B, H, Co, W), dtype=x.dtype, device=x.device)
    launch("mm_probe_nhcw_mma_bf16", x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H,
           Ci, Co, W, TH, wt, v, int(padded), int(relu), int(vec))
    return y


def _launch_nhcw(variant: str, xp: torch.Tensor, kmat: torch.Tensor, TH: int,
                 relu: bool) -> torch.Tensor:
    """P1's body as ``variant`` on x padded by a zero row above and below:
    float32 on the CUDA cores, bfloat16 on the tensor cores
    (:func:`_launch_mma`)."""
    if xp.dtype == torch.bfloat16:
        return _launch_mma(xp, kmat, TH, relu, padded=True, variant=variant)
    xp, km, vec = _kernel_inputs(xp, kmat)
    B, Hp, Ci, W = xp.shape
    Co, v = km.shape[0], VARIANTS.index(variant)
    wt = _nhcw_tile(v, Ci, Co, TH, W, 4)
    y = torch.empty((B, Hp - 2, Co, W), dtype=xp.dtype, device=xp.device)
    launch("mm_probe_nhcw_f32", xp.device, xp.data_ptr(), km.data_ptr(), y.data_ptr(), B, Hp - 2,
           Ci, Co, W, TH, wt, v, int(relu), vec)
    return y


def conv3x3_nhcw(x: torch.Tensor, k: torch.Tensor, TH: int = 8,
                 relu: bool = False) -> torch.Tensor:
    """P1: 3×3 SAME conv, x (B, H, Ci, W), k (3, 3, Ci, Co) → (B, H, Co, W);
    one block per TH output rows, from x padded by a zero row above and
    below. A bfloat16 x runs the tensor-core kernel, which reads x's rows
    itself (zeros above and below the image), and takes a bfloat16 k only
    (ValueError otherwise, as :func:`conv3x3_nhcw_v2`)."""
    B, H, Ci, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if not use_kernel(x, k):
        return conv3x3_nhcw_plain(x, k, relu)
    if x.dtype == torch.bfloat16:  # reads x's rows itself, zeros above and below
        y = _launch_mma(x, kmat_from_hwio(k), TH, relu, padded=False)
    else:
        y = _launch_nhcw("full", F.pad(x, (0, 0, 0, 0, 1, 1)), kmat_from_hwio(k), TH, relu)
    conv3x3_nhcw.launches += 1
    return y


def conv3x3_nhcw_run(variant: str, x_padded: torch.Tensor, kmat: torch.Tensor,
                     TH: int) -> torch.Tensor:
    """P2: P1's body as ``variant`` on x padded by a zero row above and below
    (B, H + 2, Ci, W) and kmat (Co, 9·Ci) → (B, H, Co, W). ``full``, ``row2``
    and ``tap-dots`` give the conv; ``asm-only`` the first Co rows of the
    im2col stack; ``dot-only`` a contraction over scratch that was never
    written, whose value is undefined. A bfloat16 x_padded runs the
    tensor-core kernels, which take a bfloat16 kmat only."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    B, Hp, Ci, W = x_padded.shape
    Co = kmat.shape[0]
    if tuple(kmat.shape) != (Co, 9 * Ci):
        raise ValueError(f"kmat must be (Co, {9 * Ci}), got {tuple(kmat.shape)}")
    _check_rows(Hp - 2, TH)
    if variant == "row2" and TH % 2:
        raise ValueError(f"row2 contracts rows in pairs: TH = {TH} must be even")
    if variant == "asm-only" and Co > 9 * Ci:
        raise ValueError(f"asm-only stores Co = {Co} of the {9 * Ci} im2col rows")
    if not use_kernel(x_padded, kmat):
        return conv3x3_nhcw_run_plain(variant, x_padded, kmat)
    y = _launch_nhcw(variant, x_padded, kmat, TH, False)
    RUN_COUNTERS[variant].launches += 1
    return y


def conv3x3_nhcw_v2(x: torch.Tensor, k: torch.Tensor, TH: int = 16,
                    relu: bool = False, ring: bool = True) -> torch.Tensor:
    """P3: P1's function, x (B, H, Ci, W), k (3, 3, Ci, Co) → (B, H, Co, W);
    each block walks several row tiles and, with ``ring``, prefetches the
    next one's halo. A bfloat16 x runs the tensor-core kernel and takes a
    bfloat16 k only (ValueError otherwise: the kernel's products are of
    bfloat16 values, and a float32 k would be rounded); ``ring=False``, its
    variant without the prefetch, exists for bfloat16 only."""
    B, H, Ci, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if not use_kernel(x, k):
        return conv3x3_nhcw_plain(x, k, relu)
    if x.dtype == torch.bfloat16:
        _refuse_float32_k("v2", k)
    if x.dtype != torch.bfloat16 and not ring:
        raise ValueError("conv probe v2: ring=False exists for the bfloat16 kernel only")
    x, km, vec = _kernel_inputs(x, kmat_from_hwio(k))
    Co, e = km.shape[0], x.element_size()
    wt = _w_tile(W, lambda t: library().mm_probe_halo_smem_bytes(Ci, Co, TH, t, e),
                 f"conv probe v2 Ci={Ci} Co={Co} TH={TH} {x.dtype}")
    y = torch.empty((B, H, Co, W), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        co_groups = -(-Co // 64)
        G = tiles_per_block(H // TH, B * co_groups * -(-W // wt))
        w = pack_weight_bf16(k.permute(3, 2, 0, 1), t=16)
        launch("mm_probe_halo_bf16", x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H,
               Ci, Co, W, TH, wt, G, int(relu), vec, int(ring))
    else:
        G = tiles_per_block(H // TH, B * -(-W // wt))
        launch("mm_probe_halo_f32", x.device, x.data_ptr(), km.data_ptr(), y.data_ptr(), B, H,
               Ci, Co, W, TH, wt, G, int(relu), vec)
    conv3x3_nhcw_v2.launches += 1
    return y


def conv3x3_flat(x: torch.Tensor, k: torch.Tensor, TH: int = 16, ndot: int = 1,
                 relu: bool = False) -> torch.Tensor:
    """P4: 3×3 SAME conv on NCHW, x (B, Ci, H, W), k (3, 3, Ci, Co) →
    (B, Co, H, W), over the flat lanes of each TH-row tile; ``ndot`` = 1 sums
    all 9·Ci terms at once, 3 adds three sums of 3·Ci terms in di order. A
    bfloat16 x runs the tensor-core kernel (each block's TH rows in
    sub-tiles of :func:`flat_rows`) and takes a bfloat16 k only."""
    B, Ci, H, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if ndot not in (1, 3):
        raise ValueError(f"ndot must be 1 or 3, got {ndot}")
    if not use_kernel(x, k):
        return conv3x3_flat_plain(x, k, ndot, relu)
    if x.dtype == torch.bfloat16:
        _refuse_float32_k("flat", k)
    x, km, vec = _kernel_inputs(x, kmat_from_hwio(k))
    Co = km.shape[0]
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    what = f"conv probe flat Ci={Ci} Co={Co} TH={TH} W={W} {x.dtype}"
    if x.dtype == torch.bfloat16:
        rows = flat_rows(TH)
        wt = _w_tile(W, lambda t: library().mm_probe_flat_smem_bytes(Ci, Co, W, rows, t, 2), what)
        w = pack_weight_bf16(k.permute(3, 2, 0, 1), t=16)
        launch("mm_probe_flat_mma_bf16", x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(), B,
               Ci, Co, H, W, rows, wt, TH // rows, ndot, int(relu), vec)
    else:
        lc = pick_size([c for c in LANE_CHUNKS if c <= -(-TH * W // 32) * 32],
                       lambda c: library().mm_probe_flat_smem_bytes(Ci, Co, W, TH, c, 4), what)
        launch("mm_probe_flat_f32", x.device, x.data_ptr(), km.data_ptr(), y.data_ptr(), B, Ci,
               Co, H, W, TH, lc, ndot, int(relu), vec)
    conv3x3_flat.launches += 1
    return y


conv3x3_nhcw.launches = 0
conv3x3_nhcw_v2.launches = 0
conv3x3_flat.launches = 0
