"""The conv-probe kernels P1–P4 and their plain PyTorch versions.

The JAX package's ``benchmarks/probe_pallas_conv*.py`` study four ways to
lay out a 3×3 SAME conv (no bias, optional ReLU) for a matrix unit. Each is
a CUDA kernel here:

- P1 :func:`conv3x3_nhcw` (``probe_pallas_conv.py:105``) and P2
  :func:`conv3x3_nhcw_run` (``probe_pallas_conv2.py:103``, P1's body in five
  variants) → ``csrc/conv_probe_nhcw.cu``: one staged halo slab, an explicit
  im2col stack, one contraction per row;
- P3 :func:`conv3x3_nhcw_v2` (``probe_pallas_conv3.py:80``) →
  ``csrc/conv_probe_halo.cu``: the same, the next tile's halo prefetched
  through a two-stage ring;
- P4 :func:`conv3x3_flat` (``probe_pallas_conv4.py:104``) →
  ``csrc/conv_probe_flat.cu``: the taps as lane shifts of a flat NCHW slab.

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

import types

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import SMEM_LIMIT, launch, library, use_kernel

# P2's variants, in the order of the Variant enum of csrc/conv_probe_nhcw.cu.
VARIANTS = ("full", "asm-only", "dot-only", "row2", "tap-dots")
RUN_COUNTERS = {v: types.SimpleNamespace(launches=0) for v in VARIANTS}

SMEM_TWO = 115_712  # at most this much per block lets two blocks share an SM
W_TILES = (128, 64, 32, 16, 8)  # column tiles of the NHCW kernels, widest first
LANE_CHUNKS = (4096, 2048, 1024, 512, 256, 128, 64, 32)  # P4's lane chunks
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the conv-probe kernels take float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    vec = x.shape[-1] % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    return x, kmat.float().contiguous(), int(vec)


def _w_tile(W: int, smem_of, what: str) -> int:
    return pick_size([t for t in W_TILES if t <= -(-W // 8) * 8], smem_of, what)


def _launch_nhcw(variant: str, xp: torch.Tensor, kmat: torch.Tensor, TH: int,
                 relu: bool) -> torch.Tensor:
    xp, km, vec = _kernel_inputs(xp, kmat)
    B, Hp, Ci, W = xp.shape
    Co, e = km.shape[0], xp.element_size()
    v = VARIANTS.index(variant)
    wt = _w_tile(W, lambda t: library().mm_probe_nhcw_smem_bytes(v, Ci, Co, TH, t, e),
                 f"conv probe {variant} Ci={Ci} Co={Co} TH={TH} {xp.dtype}")
    y = torch.empty((B, Hp - 2, Co, W), dtype=xp.dtype, device=xp.device)
    launch(f"mm_probe_nhcw_{_SUFFIX[xp.dtype]}", xp.data_ptr(), km.data_ptr(), y.data_ptr(),
           B, Hp - 2, Ci, Co, W, TH, wt, v, int(relu), vec)
    return y


def conv3x3_nhcw(x: torch.Tensor, k: torch.Tensor, TH: int = 8,
                 relu: bool = False) -> torch.Tensor:
    """P1: 3×3 SAME conv, x (B, H, Ci, W), k (3, 3, Ci, Co) → (B, H, Co, W);
    one block per TH output rows, from x padded by a zero row above and
    below."""
    B, H, Ci, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if not use_kernel(x, k):
        return conv3x3_nhcw_plain(x, k, relu)
    y = _launch_nhcw("full", F.pad(x, (0, 0, 0, 0, 1, 1)), kmat_from_hwio(k), TH, relu)
    conv3x3_nhcw.launches += 1
    return y


def conv3x3_nhcw_run(variant: str, x_padded: torch.Tensor, kmat: torch.Tensor,
                     TH: int) -> torch.Tensor:
    """P2: P1's body as ``variant`` on x padded by a zero row above and below
    (B, H + 2, Ci, W) and kmat (Co, 9·Ci) → (B, H, Co, W). ``full``, ``row2``
    and ``tap-dots`` give the conv; ``asm-only`` the first Co rows of the
    im2col stack; ``dot-only`` a contraction over scratch that was never
    written, whose value is undefined."""
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
                    relu: bool = False) -> torch.Tensor:
    """P3: P1's function, x (B, H, Ci, W), k (3, 3, Ci, Co) → (B, H, Co, W);
    each block walks several row tiles and prefetches the next one's halo."""
    B, H, Ci, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if not use_kernel(x, k):
        return conv3x3_nhcw_plain(x, k, relu)
    x, km, vec = _kernel_inputs(x, kmat_from_hwio(k))
    Co, e = km.shape[0], x.element_size()
    wt = _w_tile(W, lambda t: library().mm_probe_halo_smem_bytes(Ci, Co, TH, t, e),
                 f"conv probe v2 Ci={Ci} Co={Co} TH={TH} {x.dtype}")
    G = tiles_per_block(H // TH, B * -(-W // wt))
    y = torch.empty((B, H, Co, W), dtype=x.dtype, device=x.device)
    launch(f"mm_probe_halo_{_SUFFIX[x.dtype]}", x.data_ptr(), km.data_ptr(), y.data_ptr(),
           B, H, Ci, Co, W, TH, wt, G, int(relu), vec)
    conv3x3_nhcw_v2.launches += 1
    return y


def conv3x3_flat(x: torch.Tensor, k: torch.Tensor, TH: int = 16, ndot: int = 1,
                 relu: bool = False) -> torch.Tensor:
    """P4: 3×3 SAME conv on NCHW, x (B, Ci, H, W), k (3, 3, Ci, Co) →
    (B, Co, H, W), over the flat lanes of each TH-row tile; ``ndot`` = 1 sums
    all 9·Ci terms at once, 3 adds three sums of 3·Ci terms in di order."""
    B, Ci, H, W = x.shape
    _check_hwio(k, Ci)
    _check_rows(H, TH)
    if ndot not in (1, 3):
        raise ValueError(f"ndot must be 1 or 3, got {ndot}")
    if not use_kernel(x, k):
        return conv3x3_flat_plain(x, k, ndot, relu)
    x, km, vec = _kernel_inputs(x, kmat_from_hwio(k))
    Co, e = km.shape[0], x.element_size()
    lc = pick_size([c for c in LANE_CHUNKS if c <= -(-TH * W // 32) * 32],
                   lambda c: library().mm_probe_flat_smem_bytes(Ci, Co, W, c, e),
                   f"conv probe flat Ci={Ci} Co={Co} W={W} {x.dtype}")
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    launch(f"mm_probe_flat_{_SUFFIX[x.dtype]}", x.data_ptr(), km.data_ptr(), y.data_ptr(),
           B, Ci, Co, H, W, TH, lc, ndot, int(relu), vec)
    conv3x3_flat.launches += 1
    return y


conv3x3_nhcw.launches = 0
conv3x3_nhcw_v2.launches = 0
conv3x3_flat.launches = 0
