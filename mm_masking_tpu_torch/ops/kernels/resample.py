"""The backwards of the UNet's bilinear upsample and of the per-point weight
lookup in gather form: CUDA kernels (``csrc/resize_bwd.cu``,
``csrc/bilinear_points_bwd.cu``), their plain PyTorch versions, and the
``torch.autograd.Function``\\ s that ``models/unet.py`` and ``ops/weights.py``
use.

The JAX package has no Pallas kernel here: its upsample
(``mm_masking_tpu/models/unet.py:30``) and lookup
(``mm_masking_tpu/ops/grid_sample.py:80``) are gathers whose VJP XLA
derives. PyTorch's own VJPs of these gathers, ``index_add`` for
``index_select`` and ``grid_sampler_2d_backward`` for ``F.grid_sample``,
scatter with float atomics on the card, so a train step there would not
give the same bits twice. Each kernel here gives every destination the sum
of its contributions in a fixed order (ascending source index), accumulated
in float32 and rounded once to the gradient's type. The forwards stay
PyTorch's gathers, which are deterministic.

As every wrapper of this package, :func:`resize_bwd` and
:func:`bilinear_points_bwd` dispatch on their inputs' device: a CPU tensor
runs the plain version (PyTorch's own backward, sequential there), a CUDA
tensor launches the kernel or raises. Each counts its launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import launch, library, use_kernel

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_types(what: str, *tensors: torch.Tensor) -> None:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= _SUFFIX.keys():
        raise TypeError(f"{what} kernel takes float32 or bfloat16 tensors of one type, got "
                        f"{sorted(map(str, dtypes))}")


# ---------------------------------------------------------------- upsample axis


def resize_tables(n_in: int, n_out: int, dtype: torch.dtype, device: torch.device):
    """(i0, w0, w1) of one axis of the align-corners bilinear resize: output
    row i blends input rows i0[i] and i0[i] + 1 with the weights w0[i] and
    w1[i] in ``dtype``; index math in float32. An axis of size 1 is
    repeated: i0 = 0, w0 = 1, w1 = 0."""
    if n_in == 1:
        return (torch.zeros(n_out, dtype=torch.long, device=device),
                torch.ones(n_out, dtype=dtype, device=device),
                torch.zeros(n_out, dtype=dtype, device=device))
    pos = torch.linspace(0.0, n_in - 1.0, n_out, dtype=torch.float32, device=device)
    i0 = torch.floor(pos).long().clamp(0, n_in - 2)
    t = (pos - i0.float()).to(dtype)
    return i0, 1.0 - t, t


def resize_offsets(i0: torch.Tensor, n_in: int) -> torch.Tensor:
    """off (n_in + 1,) int32, off[j] = #{i : i0[i] < j}, on i0's device: as
    i0 is monotone, the output rows that read input row j through w0 are
    [off[j], off[j + 1]), and through w1 [off[j − 1], off[j])."""
    return torch.searchsorted(i0, torch.arange(n_in + 1, device=i0.device), out_int32=True)


def resize_bwd_plain(dy: torch.Tensor, i0: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                     n_in: int, axis: int) -> torch.Tensor:
    """Plain version: dx with ``n_in`` rows along ``axis`` from dy, as
    ``index_select``'s VJP gives it (``index_add`` of dy·w0 at i0 and of
    dy·w1 at i0 + 1, in dy's type)."""
    shape = [1] * dy.ndim
    shape[axis] = -1
    size = list(dy.shape)
    size[axis] = n_in
    dx = dy.new_zeros(size)
    dx.index_add_(axis, i0, dy * w0.reshape(shape))
    if n_in > 1:
        dx.index_add_(axis, i0 + 1, dy * w1.reshape(shape))
    return dx


def resize_bwd(dy: torch.Tensor, i0: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
               n_in: int, axis: int) -> torch.Tensor:
    """The VJP of one resized axis: dy (…, n_out, …) → dx (…, n_in, …) in
    dy's type, from the forward's own (i0, w0, w1) (:func:`resize_tables`).
    On the card each dx row sums its dy rows in ascending order in float32
    (``csrc/resize_bwd.cu``): the same bits every run."""
    if not use_kernel(dy, i0, w0, w1):
        return resize_bwd_plain(dy, i0, w0, w1, n_in, axis)
    _check_types("resize_bwd", dy, w0, w1)
    dy = dy.contiguous()
    if dy.data_ptr() % (4 * dy.element_size()):  # the kernel reads four elements at once
        dy = dy.clone()
    n_out = dy.shape[axis]
    outer, inner = math.prod(dy.shape[:axis]), math.prod(dy.shape[axis + 1:])
    off = resize_offsets(i0, n_in)
    size = list(dy.shape)
    size[axis] = n_in
    dx = torch.empty(size, dtype=dy.dtype, device=dy.device)
    launch(f"mm_resize_bwd_{_SUFFIX[dy.dtype]}", dy.device, dy.data_ptr(), w0.data_ptr(),
           w1.data_ptr(), off.data_ptr(), dx.data_ptr(), outer, n_in, n_out, inner)
    resize_bwd.launches += 1
    return dx


class _ResizeAxis(torch.autograd.Function):
    """One axis of the align-corners bilinear resize: the forward's two
    ``index_select`` gathers and blend (or a repeat, for an axis of size 1),
    the backward :func:`resize_bwd` on the forward's own tables."""

    @staticmethod
    def forward(ctx, x, out_size, axis):
        n_in = x.shape[axis]
        i0, w0, w1 = resize_tables(n_in, out_size, x.dtype, x.device)
        if n_in == 1:
            reps = [1] * x.ndim
            reps[axis] = out_size
            y = x.repeat(*reps)
        else:
            shape = [1] * x.ndim
            shape[axis] = out_size
            y = (x.index_select(axis, i0) * w0.reshape(shape)
                 + x.index_select(axis, i0 + 1) * w1.reshape(shape))
        ctx.save_for_backward(i0, w0, w1)
        ctx.n_in, ctx.axis = n_in, axis
        return y

    @staticmethod
    def backward(ctx, dy):
        i0, w0, w1 = ctx.saved_tensors
        return resize_bwd(dy, i0, w0, w1, ctx.n_in, ctx.axis), None, None


def resize_axis(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """Resize ``axis`` of x to ``out_size`` rows, bilinear with align_corners:
    output row i samples input coordinate i·(in − 1)/(out − 1)."""
    if x.shape[axis] == out_size:
        return x
    return _ResizeAxis.apply(x, out_size, axis)


# ---------------------------------------------------------------- point lookup

# The layout of ``csrc/bilinear_points_bwd.cu``: the image's bins of BIN_H
# rows × BIN_W columns (one warp each), and the points binned in chunks of
# CHUNK (one block each).
BIN_H, BIN_W, CHUNK = 10, 128, 256


def bilinear_points_bwd_plain(dout: torch.Tensor, image: torch.Tensor, coords: torch.Tensor,
                              align_corners: bool = True) -> torch.Tensor:
    """Plain version: ATen's ``grid_sampler_2d_backward`` for the image's
    gradient (bilinear, zero padding) in float32, (N, H, W) in the image's
    type."""
    dimage, _ = torch.ops.aten.grid_sampler_2d_backward(
        dout.float()[:, None, :, None], image.float()[:, None], coords.float()[:, :, None, :],
        0, 0, align_corners, [True, False])
    return dimage[:, 0].to(image.dtype)


def _pixel_xy(coords: torch.Tensor, H: int, W: int, align_corners: bool):
    """ATen's ``grid_sampler_unnormalize`` in float32: the points' pixel
    coordinates (x, y), each (N, P)."""
    c = coords.float()
    if align_corners:
        return (c[..., 0] + 1.0) * 0.5 * (W - 1), (c[..., 1] + 1.0) * 0.5 * (H - 1)
    return ((c[..., 0] + 1.0) * W - 1.0) * 0.5, ((c[..., 1] + 1.0) * H - 1.0) * 0.5


def _taps(coords: torch.Tensor, H: int, W: int, align_corners: bool):
    """The four taps of every point, tap (a, b) at index 2·b + a:
    (column, row, in the image, wx·wy) each (N, P, 4), the weights in
    float32 as ATen forms them."""
    x, y = _pixel_xy(coords, H, W, align_corners)
    fx, fy = x.floor(), y.floor()
    cols, rows, oks, ws = [], [], [], []
    for b in (0, 1):
        for a in (0, 1):
            c, r = fx + a, fy + b
            wx = x - fx if a else (fx + 1.0) - x
            wy = y - fy if b else (fy + 1.0) - y
            oks.append((c >= 0) & (c < W) & (r >= 0) & (r < H))
            cols.append(c.clamp(0, W - 1).long())
            rows.append(r.clamp(0, H - 1).long())
            ws.append(wx * wy)
    return (torch.stack(cols, -1), torch.stack(rows, -1), torch.stack(oks, -1),
            torch.stack(ws, -1))


def bilinear_points_bwd_ordered(dout: torch.Tensor, image: torch.Tensor, coords: torch.Tensor,
                                align_corners: bool = True) -> torch.Tensor:
    """The kernel's sums in plain PyTorch: every pixel adds the taps that
    land on it in ascending point order, each product ``(wx·wy)·dout``
    rounded to float32, each sum from +0 in float32, the result rounded once
    to the image's type. One step a point, over the N images at once (the
    four taps of a point land on four distinct pixels). Slow: a reference
    for tests and checks, on no path."""
    N, H, W = image.shape
    P = coords.shape[1]
    cols, rows, ok, w = _taps(coords, H, W, align_corners)
    item = torch.arange(N, device=image.device)[:, None, None] * (H * W)
    sink = N * H * W  # where the taps outside the image go
    idx = torch.where(ok, item + rows * W + cols, sink)
    val = w * dout.float()[..., None]
    acc = torch.zeros(sink + 1, dtype=torch.float32, device=image.device)
    for p in range(P):
        i = idx[:, p].reshape(-1)
        acc[i] = acc[i] + val[:, p].reshape(-1)
    return acc[:sink].view(N, H, W).to(image.dtype)


def lookup_layout(N: int, P: int, H: int, W: int) -> tuple[int, int]:
    """(chunks of points G, the image's bins) of one kernel call."""
    return -(-P // CHUNK), -(-H // BIN_H) * -(-W // BIN_W)


def bin_points_plain(coords: torch.Tensor, H: int, W: int, align_corners: bool = True):
    """The kernel's binning in plain PyTorch: (lists (N, G, 4·CHUNK) int32,
    starts (N, bins + 1, G) int32). Chunk g holds points g·CHUNK …
    (g + 1)·CHUNK − 1; each of its points enters the list of every bin of
    BIN_H × BIN_W pixels that one of its taps reaches (once a bin); the list
    holds the bins' entries one bin after another, each bin's in ascending
    p, and bin t's begin at starts[n, t, g] (t = bins: the end). Unused
    entries are −1. The kernel's entries carry p's bits beside the point's
    pixel coordinates and dout."""
    N, P, _ = coords.shape
    G, bins = lookup_layout(N, P, H, W)
    cols, rows, ok, _ = _taps(coords, H, W, align_corners)
    t = torch.where(ok, rows // BIN_H * -(-W // BIN_W) + cols // BIN_W, -1)
    for s in (1, 2, 3):  # a point's taps in one bin make one entry, the first
        t[..., s] = torch.where((t[..., :s] == t[..., s:s + 1]).any(-1), -1, t[..., s])
    n, p, s = (t >= 0).nonzero(as_tuple=True)
    seg, bin_ = n * G + p // CHUNK, t[n, p, s]
    order = torch.argsort((seg * bins + bin_) * P + p)
    seg, bin_, p = seg[order], bin_[order], p[order]
    counts = torch.bincount(seg * bins + bin_, minlength=N * G * bins).view(N * G, bins)
    starts = F.pad(counts.cumsum(-1), (1, 0))
    first = F.pad(counts.sum(-1).cumsum(0), (1, 0))[:-1]
    lists = torch.full((N * G, 4 * CHUNK), -1, dtype=torch.int32, device=coords.device)
    lists[seg, torch.arange(len(seg), device=coords.device) - first[seg]] = p.int()
    return (lists.view(N, G, 4 * CHUNK),
            starts.view(N, G, bins + 1).transpose(1, 2).int().contiguous())


def _checked_layout() -> None:
    """The kernel's compiled layout must be the one allocated for it."""
    if not _checked_layout.done:
        got = (ctypes.c_int * 3)()
        library().mm_bilinear_points_layout(got)
        if tuple(got) != (BIN_H, BIN_W, CHUNK):
            raise RuntimeError(f"bilinear_points_bwd.cu has the layout {tuple(got)}, "
                               f"not {(BIN_H, BIN_W, CHUNK)}")
        _checked_layout.done = True


_checked_layout.done = False


def _lookup_bwd_kernel(dout: torch.Tensor, image: torch.Tensor, coords: torch.Tensor,
                       align_corners: bool):
    """Both launches of ``csrc/bilinear_points_bwd.cu`` on CUDA tensors:
    (dimage, lists, starts), the scratch as :func:`bin_points_plain` lays it
    out, each entry of ``lists`` (N, G, 4·CHUNK, 4) float32 the point's pixel
    coordinates, its dout and p's bits."""
    _check_types("bilinear_points_bwd", dout, image, coords)
    N, H, W = image.shape
    P = coords.shape[1]
    if coords.shape != (N, P, 2) or dout.shape != (N, P):
        raise ValueError(f"coords {tuple(coords.shape)} and dout {tuple(dout.shape)} do not "
                         f"fit image {tuple(image.shape)}")
    _checked_layout()
    dout, coords = dout.contiguous(), coords.contiguous()
    if coords.data_ptr() % (2 * coords.element_size()):  # a point's (x, y) loads as one vector
        coords = coords.clone()
    G, bins = lookup_layout(N, P, H, W)
    dimage = torch.empty((N, H, W), dtype=image.dtype, device=image.device)
    lists = torch.empty((N, G, 4 * CHUNK, 4), dtype=torch.float32, device=image.device)
    starts = torch.empty((N, bins + 1, G), dtype=torch.int32, device=image.device)
    launch(f"mm_bilinear_points_bwd_{_SUFFIX[image.dtype]}", image.device, dout.data_ptr(),
           coords.data_ptr(), dimage.data_ptr(), lists.data_ptr(), starts.data_ptr(), N, P, H,
           W, int(align_corners))
    return dimage, lists, starts


def bilinear_points_bwd(dout: torch.Tensor, image: torch.Tensor, coords: torch.Tensor,
                        align_corners: bool = True) -> torch.Tensor:
    """The image's gradient of the lookup of ``image`` (N, H, W) at
    ``coords`` (N, P, 2) (normalised (x, y), the image's type) under
    ``dout`` (N, P): (N, H, W) in the image's type. On the card the points
    are binned once by image bin, then each bin sums the taps that land on
    each pixel in ascending point order in float32
    (``csrc/bilinear_points_bwd.cu``): the bits of
    :func:`bilinear_points_bwd_ordered`, every run. Only the image's shape
    and type are read."""
    if not use_kernel(dout, image, coords):
        return bilinear_points_bwd_plain(dout, image, coords, align_corners)
    dimage, _, _ = _lookup_bwd_kernel(dout, image, coords, align_corners)
    bilinear_points_bwd.launches += 1
    return dimage


class _SamplePoints(torch.autograd.Function):
    """``F.grid_sample`` of a single-channel image at points, in float32 (a
    bfloat16 image's samples are rounded once to bfloat16), with the image's
    gradient by :func:`bilinear_points_bwd`, whose coordinates and weights
    are the same float32 ones. The coordinates' gradient is per point and
    scatters nothing: ATen's backward gives it, asked for that gradient
    alone."""

    @staticmethod
    def forward(ctx, image, coords, align_corners):
        ctx.save_for_backward(image, coords)
        ctx.align_corners = align_corners
        out = F.grid_sample(image.float()[:, None], coords.float()[:, :, None, :],
                            mode="bilinear", padding_mode="zeros", align_corners=align_corners)
        return out[:, 0, :, 0].to(image.dtype)

    @staticmethod
    def backward(ctx, dout):
        image, coords = ctx.saved_tensors
        dimage = dcoords = None
        if ctx.needs_input_grad[0]:
            dimage = bilinear_points_bwd(dout, image, coords, ctx.align_corners)
        if ctx.needs_input_grad[1]:
            _, dgrid = torch.ops.aten.grid_sampler_2d_backward(
                dout.float()[:, None, :, None], image.float()[:, None],
                coords.float()[:, :, None, :], 0, 0, ctx.align_corners, [False, True])
            dcoords = dgrid[:, :, 0, :].to(coords.dtype)
        return dimage, dcoords, None


def sample_points(image: torch.Tensor, coords: torch.Tensor,
                  align_corners: bool = True) -> torch.Tensor:
    """Bilinear lookup (zero padding) of ``image`` (N, H, W) at normalised
    coordinates ``coords`` (N, P, 2) of the image's type → (N, P)."""
    return _SamplePoints.apply(image, coords, align_corners)


resize_bwd.launches = 0
bilinear_points_bwd.launches = 0
