"""UNet weight-mask network in NCHW (counterpart of ``mm_masking_tpu.models.unet``).

Reference architecture (``icp_weight_policy.py``):
  * encoder blocks conv3x3 → relu → [bn] → conv3x3 → relu → [bn] → [dropout],
    with a 2×2 max-pool after every block but the first; the skip of each
    block is its *input*;
  * each decoder block is applied twice with the same weights, once on the
    upsampled features and once on ``cat([skip, x])``;
  * bilinear upsampling with align_corners (index math in float32);
  * a final 1×1 conv and a sigmoid, both in float32: the mask leaves the
    UNet as float32 whatever the conv type.

Every 3×3 conv goes through the CUDA kernels of
:mod:`mm_masking_tpu_torch.ops.kernels.conv2d` on a CUDA input (forward and
backward), with the ReLU fused into its epilogue unless the activation is
leaky. The 1×1 conv stays a PyTorch op, as it stayed an XLA op in the JAX
package.

Training mode (``train=True``) draws its inverted-dropout masks from an
explicit ``torch.Generator`` and nothing from PyTorch's global generator, so
a training step is reproducible from a seed. Batch norm (``batch_norm=True``)
is flax's ``nn.BatchNorm``, written out (:func:`batch_norm`): in training it
normalises with the batch's statistics and updates the running ones in
place; otherwise it normalises with the running ones.

Under a mesh (``mesh=``, ``rows=``) the input is this rank's rows of a
global batch: the batch norm's statistics are the global batch's, and each
dropout mask is the global batch's mask, of which the rank keeps its rows,
so N ranks compute what one device computes.
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
    both rounded to x's type, as a matrix product over C in float32 (TF32
    off): the products of x's values are exact, the sum and the bias are
    float32, and so is the result, whatever x's type. A bfloat16 x so gives
    the head what an XLA fusion of the conv, the bias and the sigmoid gives
    on the TPU, with no rounding of the logits to 8 bits (ROADMAP §3 fault
    4); a float32 x is unchanged. Not ``F.conv2d``: cuDNN's float32 weight
    gradient of this conv adds with atomics on the card, where the gradients
    of the product are matrix products and a sum over the batch, the same
    bits every run."""
    B, C, H, W = x.shape
    w = weight.to(x.dtype)[:, :, 0, 0].float()
    y = torch.matmul(w, x.reshape(B, C, H * W).float())
    return (y + bias.to(x.dtype).float()[:, None]).reshape(B, -1, H, W)


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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability 1 − rate and scale the kept ones by 1 / (1 − rate). With
    ``rows`` = (first row, global rows), x is those rows of a global batch:
    the mask is drawn for the global batch and x takes its rows."""
    keep_prob = 1.0 - rate
    if rows is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        start, total = rows
        u = torch.rand((total,) + x.shape[1:], generator=generator,
                       device=x.device)[start:start + x.shape[0]]
    keep = u < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


# flax ``nn.BatchNorm``'s defaults: epsilon, and the running averages' decay.
BN_EPS, BN_MOMENTUM = 1e-5, 0.99


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool, mesh=None) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over the channels of x (B, C, H, W), its
    statistics in float32 whatever x's type, the result in x's type.

    ``train``: the batch's mean and biased variance, E[x²] − E[x]² floored
    at 0 (flax's fast variance), normalise x, and the running statistics
    take ``ra ← 0.99·ra + 0.01·stat`` in place, the biased variance
    included (``torch.nn.BatchNorm2d`` would store the unbiased one).
    Otherwise the running statistics normalise x. Under a ``mesh`` the
    statistics are the global batch's: one all-reduce of (E[x], E[x²]) in
    the forward, and one of their cotangents in the backward, as each rank
    normalises its own rows with them."""
    if train:
        xf = x.float()
        stats = torch.stack([xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))])
        if mesh is not None:
            stats = mesh.sum(stats, local_grad=True) / mesh.size
        mean, mean2 = stats.unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean)
            bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + BN_EPS) * bn.weight
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


class ConvBlock(nn.Module):
    """conv3x3-relu[-bn]-conv3x3-relu[-bn][-dropout][-maxpool]."""

    def __init__(self, cin: int, features: int, leaky: bool, batch_norm: bool,
                 dropout: float, pool: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv3x3(cin, features, dtype)
        self.conv1 = Conv3x3(features, features, dtype)
        # The parameters and running statistics of :func:`batch_norm`.
        self.bn0 = nn.BatchNorm2d(features, eps=BN_EPS) if batch_norm else None
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS) if batch_norm else None
        self.dropout = dropout
        self.leaky = leaky
        self.pool = pool

    def _act(self, conv: Conv3x3, bn: nn.BatchNorm2d | None, x: torch.Tensor,
             train: bool, mesh):
        x = conv(x, relu=not self.leaky)  # plain ReLU rides the conv epilogue
        if self.leaky:
            x = F.leaky_relu(x, 0.1)
        return batch_norm(x, bn, train, mesh) if bn is not None else x

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, mesh=None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """``train``: batch statistics, and dropout from ``generator``."""
        x = self._act(self.conv0, self.bn0, x, train, mesh)
        x = self._act(self.conv1, self.bn1, x, train, mesh)
        if train and self.dropout > 0.0:
            x = dropout(x, self.dropout, generator, rows)
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
                generator: torch.Generator | None = None, mesh=None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        """``train``: dropout masks from ``generator`` (on x's device), drawn
        anew at each block application and required when dropout > 0; batch
        norm on the batch's statistics, updating the running ones in place
        at each block application (a decoder block's twice, in order).
        ``mesh`` and ``rows`` = (first row, global rows): x is this rank's
        rows of a batch sharded over the mesh."""
        if train and self.blocks[0].dropout > 0.0 and generator is None:
            raise ValueError("training with dropout needs a torch.Generator")
        kw = dict(train=train, generator=generator, mesh=mesh, rows=rows)
        x = x.to(self.dtype)
        skips = []
        for block in self.blocks[:self.n_enc]:
            skips.append(x)
            x = block(x, **kw)
        skips.reverse()
        for i, block in enumerate(self.blocks[self.n_enc:]):
            skip = skips[i]
            x = upsample_bilinear_align_corners(x, tuple(skip.shape[2:]))
            x = block(x, **kw)
            x = block(torch.cat([skip, x], dim=1), **kw)
        return torch.sigmoid(conv1x1(x, self.final.weight, self.final.bias))[:, 0]


def _stage_sizes(enc_channels: Sequence[int], size) -> list[tuple[int, int]]:
    """(H, W) of each encoder block's input: the max-pool after every block
    but the first floors both sides."""
    h, w = (size, size) if isinstance(size, int) else size
    sizes = []
    for i, _ in enumerate(enc_channels):
        sizes.append((h, w))
        if i > 0:
            h, w = h // 2, w // 2
    return sizes + [(h, w)]


def conv3x3_shapes(enc_channels: Sequence[int] = (8, 16, 32, 64, 128, 256),
                   width=640, in_channels: int = 1) -> list[tuple[int, ...]]:
    """The 3×3 convs of one :class:`UNet` forward, in the order they run
    (each decoder block twice): (Ci, Co, H) on a width × width image, or
    (Ci, Co, H, W) when ``width`` is an (H, W) pair, as the polar scan is."""
    sizes = _stage_sizes(enc_channels, width)
    shapes, cin = [], in_channels
    for i, ch in enumerate(enc_channels):
        shapes += [(cin, ch, *sizes[i]), (ch, ch, *sizes[i])]
        cin = ch
    for i, feat in enumerate(list(enc_channels)[-2::-1]):
        hw = sizes[-2 - i]
        shapes += [(cin, feat, *hw), (feat, feat, *hw), (2 * feat, feat, *hw), (feat, feat, *hw)]
        cin = feat
    if isinstance(width, int):
        return [s[:3] for s in shapes]
    return shapes


def upsample_shapes(enc_channels: Sequence[int] = (8, 16, 32, 64, 128, 256),
                    width=640) -> list[tuple[int, ...]]:
    """The upsamples of one :class:`UNet` forward, in the order they run: (C,
    h, H), C channels from h × h to H × H, or (C, h, w, H, W) when ``width``
    is an (H, W) pair."""
    sizes = _stage_sizes(enc_channels, width)
    shapes, cin = [], enc_channels[-1]
    for i, feat in enumerate(list(enc_channels)[-2::-1]):
        shapes.append((cin, *sizes[-1 - i], *sizes[-2 - i]))
        cin = feat
    if isinstance(width, int):
        return [(c, h, H) for c, h, _, H, _ in shapes]
    return shapes
