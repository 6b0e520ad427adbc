"""3×3 SAME stride-1 conv (+bias, optional fused ReLU): the CUDA kernel
``csrc/conv3x3.cu`` and its plain PyTorch version.

Counterpart of ``mm_masking_tpu.ops.pallas.conv2d.conv3x3_nhcw`` (forward).
The port keeps PyTorch's NCHW layout and OIHW weights; the JAX package's
NHCW layout existed only to fill the TPU's 128 lanes. Inputs are float32 or
bfloat16; accumulation is float32 and the output has the input's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import launch, use_kernel

_ENTRY = {torch.float32: "mm_conv3x3_f32", torch.bfloat16: "mm_conv3x3_bf16"}


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in float32 (TF32 off), rounded to x's type."""
    y = F.conv2d(x.float(), weight.float(), bias.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """x (B, Ci, H, W); weight (Co, Ci, 3, 3); bias (Co,) → (B, Co, H, W).

    A CPU input runs :func:`conv3x3_plain`; a CUDA input launches the kernel.
    """
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Ci, H, W), got {tuple(x.shape)}")
    B, Ci, H, W = x.shape
    Co = weight.shape[0]
    if weight.shape != (Co, Ci, 3, 3) or bias.shape != (Co,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not fit "
            f"Ci={Ci}")
    if not use_kernel(x, weight, bias):
        return conv3x3_plain(x, weight, bias, relu)
    if x.dtype not in _ENTRY:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3x3 kernel needs a contiguous NCHW input")
    # (Co, Ci, kh, kw) → (Ci, 9, Co): one tap's output channels are contiguous.
    w9 = weight.float().permute(1, 2, 3, 0).reshape(Ci, 9, Co).contiguous()
    b = bias.float().contiguous()
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    launch(_ENTRY[x.dtype], x.data_ptr(), w9.data_ptr(), b.data_ptr(), y.data_ptr(),
           B, Ci, Co, H, W, int(relu))
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
