"""UNet weight-mask network in NCHW (counterpart of ``mm_masking_tpu.models.unet``).

Reference architecture (``icp_weight_policy.py``):
  * encoder blocks conv3x3 → relu → [bn] → conv3x3 → relu → [bn] → [dropout],
    with a 2×2 max-pool after every block but the first; the skip of each
    block is its *input*;
  * each decoder block is applied twice with the same weights, once on the
    upsampled features and once on ``cat([skip, x])``;
  * bilinear upsampling with align_corners (index math in float32);
  * a final 1×1 conv and a sigmoid.

Every 3×3 conv goes through the CUDA kernels of
:mod:`mm_masking_tpu_torch.ops.kernels.conv2d` on a CUDA input (forward and
backward), with the ReLU fused into its epilogue unless the activation is
leaky. The 1×1 conv stays a PyTorch op, as it stayed an XLA op in the JAX
package.

Training mode (``train=True``) draws its inverted-dropout masks from an
explicit ``torch.Generator`` and nothing from PyTorch's global generator, so
a training step is reproducible from a seed. Batch norm does not train yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels.conv2d import conv3x3
from mm_masking_tpu_torch.ops.kernels.resample import resize_axis


def upsample_bilinear_align_corners(
    x: torch.Tensor, size: tuple[int, int], axes: tuple[int, int] = (2, 3)
) -> torch.Tensor:
    """Separable bilinear resize with align_corners=True: output pixel i
    samples input coordinate ``i * (in - 1) / (out - 1)``. Each axis's
    backward is the gather-form kernel of
    :func:`mm_masking_tpu_torch.ops.kernels.resample.resize_axis` on the card."""
    x = resize_axis(x, size[0], axes[0])
    return resize_axis(x, size[1], axes[1])


def conv1x1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """1×1 conv of x (B, C, H, W) with weight (Co, C, 1, 1) and bias (Co,),
    both rounded to x's type, as a matrix product over C (float32 sums, TF32
    off). Not ``F.conv2d``: cuDNN's float32 weight gradient of this conv adds
    with atomics on the card, where the gradients of the product are matrix
    products and a sum over the batch, the same bits every run."""
    B, C, H, W = x.shape
    y = torch.matmul(weight.to(x.dtype)[:, :, 0, 0], x.reshape(B, C, H * W))
    return (y + bias.to(x.dtype)[:, None]).reshape(B, -1, H, W)


class Conv3x3(nn.Module):
    """3×3 SAME conv with OIHW weight (Co, Ci, 3, 3) and bias (Co,)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return conv3x3(x.to(self.dtype), self.weight.to(self.dtype),
                       self.bias.to(self.dtype), relu)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1 − rate and scale the kept ones by 1 / (1 − rate)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBlock(nn.Module):
    """conv3x3-relu[-bn]-conv3x3-relu[-bn][-dropout][-maxpool]."""

    def __init__(self, cin: int, features: int, leaky: bool, batch_norm: bool,
                 dropout: float, pool: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv3x3(cin, features, dtype)
        self.conv1 = Conv3x3(features, features, dtype)
        # flax BatchNorm: epsilon 1e-5, running-average decay 0.99.
        self.bn0 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.01) if batch_norm else None
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5, momentum=0.01) if batch_norm else None
        self.dropout = dropout
        self.leaky = leaky
        self.pool = pool

    def _act(self, conv: Conv3x3, bn: nn.BatchNorm2d | None, x: torch.Tensor):
        x = conv(x, relu=not self.leaky)  # plain ReLU rides the conv epilogue
        if self.leaky:
            x = F.leaky_relu(x, 0.1)
        return bn(x) if bn is not None else x

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """``generator`` given: training mode, dropout on."""
        x = self._act(self.conv0, self.bn0, x)
        x = self._act(self.conv1, self.bn1, x)
        if generator is not None and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator)
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class UNet(nn.Module):
    """Full-resolution sigmoid weight mask: (B, C, H, W) → (B, H, W)."""

    def __init__(
        self,
        in_channels: int = 1,
        enc_channels: Sequence[int] = (8, 16, 32, 64, 128, 256),
        leaky: bool = False,
        batch_norm: bool = False,
        dropout: float = 0.05,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        enc = list(enc_channels)
        dec = enc[::-1]
        blocks = []
        cin = in_channels
        for i, ch in enumerate(enc):
            blocks.append(ConvBlock(cin, ch, leaky, batch_norm, dropout, i > 0, dtype))
            cin = ch
        # Decoder block i takes dec[i] channels twice: the upsampled features,
        # then cat([skip, x]) with dec[i] = 2 · dec[i + 1].
        for i in range(len(dec) - 1):
            blocks.append(
                ConvBlock(dec[i], dec[i + 1], leaky, batch_norm, dropout, False, dtype))
        self.blocks = nn.ModuleList(blocks)
        self.final = nn.Conv2d(enc[0], 1, kernel_size=1)
        self.n_enc = len(enc)
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform conv kernels and zero biases (the reference's
        ``weights_init``), drawn on the CPU from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (Conv3x3, nn.Conv2d)):
                w = torch.empty(mod.weight.shape)
                nn.init.xavier_uniform_(w, generator=generator)
                with torch.no_grad():
                    mod.weight.copy_(w)
                    mod.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train``: dropout masks from ``generator`` (on x's device), drawn
        anew at each block application; required when dropout > 0."""
        if train:
            if self.blocks[0].bn0 is not None:
                raise NotImplementedError(
                    "batch-norm training is not ported yet: ROADMAP.md queue 1 "
                    "item 19, 'Batch-norm training'")
            if self.blocks[0].dropout > 0.0 and generator is None:
                raise ValueError("training with dropout needs a torch.Generator")
        else:
            generator = None
        x = x.to(self.dtype)
        skips = []
        for block in self.blocks[:self.n_enc]:
            skips.append(x)
            x = block(x, generator)
        skips.reverse()
        for i, block in enumerate(self.blocks[self.n_enc:]):
            skip = skips[i]
            x = upsample_bilinear_align_corners(x, tuple(skip.shape[2:]))
            x = block(x, generator)
            x = block(torch.cat([skip, x], dim=1), generator)
        return torch.sigmoid(conv1x1(x, self.final.weight, self.final.bias))[:, 0]


def conv3x3_shapes(enc_channels: Sequence[int] = (8, 16, 32, 64, 128, 256),
                   width: int = 640, in_channels: int = 1) -> list[tuple[int, int, int]]:
    """(Ci, Co, H) of the 3×3 convs of one :class:`UNet` forward on a
    width × width image, in the order they run (each decoder block twice)."""
    shapes, skips, h, cin = [], [], width, in_channels
    for i, ch in enumerate(enc_channels):
        skips.append(h)
        shapes += [(cin, ch, h), (ch, ch, h)]
        cin = ch
        if i > 0:  # the block's max-pool
            h //= 2
    for i, feat in enumerate(list(enc_channels)[-2::-1]):
        h = skips[-1 - i]
        shapes += [(cin, feat, h), (feat, feat, h), (2 * feat, feat, h), (feat, feat, h)]
        cin = feat
    return shapes


def upsample_shapes(enc_channels: Sequence[int] = (8, 16, 32, 64, 128, 256),
                    width: int = 640) -> list[tuple[int, int, int]]:
    """(C, h, H) of the upsamples of one :class:`UNet` forward on a width ×
    width image, in the order they run: C channels from h × h to H × H."""
    skips, h = [], width
    for i, _ in enumerate(enc_channels):
        skips.append(h)
        if i > 0:  # the block's max-pool
            h //= 2
    shapes, cin = [], enc_channels[-1]
    for i, feat in enumerate(list(enc_channels)[-2::-1]):
        shapes.append((cin, h, skips[-1 - i]))
        h, cin = skips[-1 - i], feat
    return shapes
