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


def upsample_bilinear_align_corners(
    x: torch.Tensor, size: tuple[int, int], axes: tuple[int, int] = (2, 3)
) -> torch.Tensor:
    """Separable bilinear resize with align_corners=True: output pixel i
    samples input coordinate ``i * (in - 1) / (out - 1)``."""

    def axis_resize(arr, in_size, out_size, axis):
        if in_size == out_size:
            return arr
        if in_size == 1:
            reps = [1] * arr.ndim
            reps[axis] = out_size
            return arr.repeat(*reps)
        pos = torch.linspace(0.0, in_size - 1.0, out_size, dtype=torch.float32,
                             device=arr.device)
        i0 = torch.floor(pos).long().clamp(0, in_size - 2)
        t = (pos - i0.float()).to(arr.dtype)
        shape = [1] * arr.ndim
        shape[axis] = out_size
        t = t.reshape(shape)
        a0 = arr.index_select(axis, i0)
        a1 = arr.index_select(axis, i0 + 1)
        return a0 * (1.0 - t) + a1 * t

    x = axis_resize(x, x.shape[axes[0]], size[0], axes[0])
    return axis_resize(x, x.shape[axes[1]], size[1], axes[1])


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
        x = F.conv2d(x, self.final.weight.to(self.dtype), self.final.bias.to(self.dtype))
        return torch.sigmoid(x)[:, 0]
