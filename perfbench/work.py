"""The yardstick's arithmetic: the H100's published peaks and the UNet's work.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit):
989 TFLOP/s for bfloat16 matrix products on the tensor cores, 495 TFLOP/s
for TF32 there, of which a float32 product at float32 accuracy through
3xTF32 (three TF32 products for each float32 one) gets 495 / 3, and
3.35 TB/s of HBM. The port's 3x3 convs run in exactly these two ways.

The UNet's 3x3 convs are listed from its architecture (encoder blocks of two
convs, a 2x2 max-pool after every block but the first; each decoder block
applied twice, once on the upsampled features and once on
``cat([skip, x])``), then a 1x1 head to one channel. A conv of ``ci`` to
``co`` channels on an ``h`` x ``w`` image does ``2 * 9 * ci * co * h * w``
operations a pair in its forward pass, as many for the input's gradient
(dx) and as many for the kernel's (dk).
"""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_MATMUL_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}


def input_size(model: dict):
    """The UNet's input size of a configuration's model block: the cartesian
    width, or the polar scan's (azimuths, range bins)."""
    if model["network_input_type"] == "polar":
        return tuple(model["polar_shape"])
    return model["cart_pixel_width"]


def _size(size) -> tuple[int, int]:
    return (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))


def conv3x3_shapes(enc_channels: Sequence[int], size, in_channels: int = 1
                   ) -> list[tuple[int, int, int, int]]:
    """(ci, co, h, w) of each 3x3 conv of one forward pass, in the order
    they run; ``size`` is the input's width (square) or its (h, w)."""
    h, w = _size(size)
    sizes = []  # each encoder block's input; the pool after all but the first floors
    for i, _ in enumerate(enc_channels):
        sizes.append((h, w))
        if i > 0:
            h, w = h // 2, w // 2
    sizes.append((h, w))
    shapes, cin = [], in_channels
    for (h, w), ch in zip(sizes, enc_channels):
        shapes += [(cin, ch, h, w), (ch, ch, h, w)]
        cin = ch
    for i, feat in enumerate(list(enc_channels)[-2::-1]):
        h, w = sizes[-2 - i]
        shapes += [(cin, feat, h, w), (feat, feat, h, w), (2 * feat, feat, h, w),
                   (feat, feat, h, w)]
        cin = feat
    return shapes


def conv_flops(ci: int, co: int, h: int, w: int) -> float:
    return 18.0 * ci * co * h * w


def head_flops(enc_channels: Sequence[int], size) -> float:
    h, w = _size(size)
    return 2.0 * enc_channels[0] * h * w


def forward_flops(enc_channels: Sequence[int], size, in_channels: int = 1) -> float:
    """Operations of one pair's UNet forward pass (the 3x3 convs and the head)."""
    return (sum(conv_flops(*s) for s in conv3x3_shapes(enc_channels, size, in_channels))
            + head_flops(enc_channels, size))


def train_flops(enc_channels: Sequence[int], size, in_channels: int = 1) -> float:
    """Operations of one pair's UNet forward and backward: 3x the forward,
    less the first conv's dx, which no one needs (the input has no
    gradient)."""
    first = conv3x3_shapes(enc_channels, size, in_channels)[0]
    return 3.0 * forward_flops(enc_channels, size, in_channels) - conv_flops(*first)


def conv_bound_s(enc_channels: Sequence[int], size, batch: int, dtype: str,
                 in_channels: int = 1, train: bool = True) -> float:
    """The least time one step's 3x3 convs could take on the card: for each
    launch (the forward, dx but for the first conv, dk) the larger of its
    operations at the tensor cores' peak for ``dtype`` and its bytes at
    HBM's rate, each input read once and each output written once
    (activations in ``dtype``, weights, biases and dk in float32), summed."""
    elem = 2 if dtype == "bfloat16" else 4
    peak = PEAK_MATMUL_FLOPS[dtype]
    total = 0.0
    for i, (ci, co, h, w) in enumerate(conv3x3_shapes(enc_channels, size, in_channels)):
        ops = batch * conv_flops(ci, co, h, w)
        io = elem * batch * h * w * (ci + co) + 4 * 9 * ci * co
        jobs = [io + 4 * co]  # forward: x, weight, bias in; y out
        if train:
            jobs += [io] * (2 if i > 0 else 1)  # dx (dy, weight in; dx out); dk (x, dy in)
        total += sum(max(ops / peak, nbytes / HBM_BYTES_PER_S) for nbytes in jobs)
    return total
