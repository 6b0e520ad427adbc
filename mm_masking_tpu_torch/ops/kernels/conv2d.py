"""3×3 SAME stride-1 conv (+bias, optional fused ReLU) with its backward: the
CUDA kernels of K2 (forward, and dx of the backward, on the tensor cores:
``csrc/conv3x3_tc.cu`` through 3xTF32 for float32, ``csrc/conv3x3_bf16_tc.cu``
for bfloat16) and K3 (weight gradient, on the tensor cores:
``csrc/conv3x3_dk_tf32_tc.cu`` through 3xTF32 for float32,
``csrc/conv3x3_dk_tc.cu`` for bfloat16), and their plain PyTorch versions.

Counterpart of ``mm_masking_tpu.ops.pallas.conv2d.conv3x3_nhcw`` and its
custom VJP. The port keeps PyTorch's NCHW layout and OIHW weights; the JAX
package's NHCW layout existed only to fill the TPU's 128 lanes. Inputs are
float32 or bfloat16; the forward and dx round the weight to their input's
type, as the reference rounds ``kmat`` (``conv2d.py:236``, ``:263``), and
keep the bias in float32; accumulation is float32 and each result has its
operand's type.

:func:`conv3x3` is a ``torch.autograd.Function`` on every device. Only its
three innermost calls dispatch: :func:`conv3x3_forward` (K2),
:func:`conv3x3_dx` (K2 on dy with the rotated, transposed weight) and
:func:`conv3x3_dk` (K3) launch their kernel on CUDA tensors and run their
plain version on CPU tensors, so the CPU tests run the backward's own logic.
Each of the three counts its launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import SMEM_LIMIT, launch, library, use_kernel

_ENTRY = {torch.float32: "mm_conv3x3_f32", torch.bfloat16: "mm_conv3x3_bf16"}
# K3's entry and the host function that sizes its scratch, by input type.
_DK_ENTRY = {torch.float32: ("mm_conv3x3_dk_f32", "mm_conv3x3_dk_chunks"),
             torch.bfloat16: ("mm_conv3x3_dk_bf16", "mm_conv3x3_dk_bf16_chunks")}


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in float32 (TF32 off) of x and the weight
    rounded to x's type, rounded to x's type."""
    y = F.conv2d(x.float(), weight.to(x.dtype).float(), bias.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _rot180_t(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3) → (Ci, Co, 3, 3): the weight of the conv adjoint."""
    return weight.flip(2, 3).transpose(0, 1)


def conv3x3_dx_plain(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain dx: ``F.conv2d`` of dy with the rotated, transposed weight,
    rounded to dy's type."""
    w = _rot180_t(weight.to(dy.dtype).float())
    return F.conv2d(dy.float(), w, padding=1).to(dy.dtype)


def conv3x3_dk_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain dk (Co, Ci, 3, 3) in float32: ``torch.nn.grad.conv2d_weight``."""
    shape = (dy.shape[1], x.shape[1], 3, 3)
    return torch.nn.grad.conv2d_weight(x.float(), shape, dy.float(), padding=1)


def ci_tile(ci: int) -> int:
    """Input channels of one chunk of the bfloat16 kernel's K: 1 for Ci = 1
    (the 9 taps in one k-step), 8 up to 8 (two taps a k-step), else 16 (one
    tap a k-step). ``csrc/conv3x3_bf16_tc.cu::with_cfg`` picks the same."""
    return 1 if ci == 1 else 8 if ci <= 8 else 16


def pack_weight_bf16(weight: torch.Tensor, t: int | None = None) -> torch.Tensor:
    """(Co, Ci, 3, 3) → bfloat16 (n_chunks, 9, Cop, t), the bfloat16 kernel's
    weights: t = ci_tile(Ci) unless given, n_chunks = ⌈Ci / t⌉, Cop = Co
    rounded up to 8; element [c, 3·kh + kw, co, k] is weight[co, c·t + k, kh,
    kw], zero past Ci and Co. One chunk's taps are contiguous, and each (tap,
    co) row of t input channels loads as 16-byte vectors."""
    Co, Ci = weight.shape[:2]
    t = t or ci_tile(Ci)
    cip = -(-Ci // t) * t
    w = weight.to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, Co, Ci)
    w = F.pad(w, (0, cip - Ci, 0, -Co % 8))
    return w.reshape(9, w.shape[1], cip // t, t).permute(2, 0, 1, 3).contiguous()


def _launch_forward(x, weight, bias, relu):
    if x.dtype not in _ENTRY:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    B, Ci, H, W = x.shape
    Co = weight.shape[0]
    if x.dtype == torch.float32:
        smem, block = library().mm_conv3x3_f32_smem_bytes(Co, W), f"Co={Co}, W={W}"
        # (Co, Ci, kh, kw) → (9, Ci, Co), both channel counts zero-padded to
        # a multiple of 8: one chunk's weights load as 16-byte vectors.
        w9 = F.pad(weight.float().permute(2, 3, 1, 0).reshape(9, Ci, Co),
                   (0, -Co % 8, 0, -Ci % 8))
    else:
        smem, block = library().mm_conv3x3_bf16_smem_bytes(Ci, Co), f"Ci={Ci}, Co={Co}"
        w9 = pack_weight_bf16(weight)
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv3x3 {str(x.dtype)[6:]} kernel: a block for {block} needs "
                         f"{smem} bytes of shared memory, more than the {SMEM_LIMIT} it may "
                         f"have")
    x, w9 = x.contiguous(), w9.contiguous()  # x: a no-op inside the autograd Function
    b = bias.float().contiguous()
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    launch(_ENTRY[x.dtype], x.device, x.data_ptr(), w9.data_ptr(), b.data_ptr(), y.data_ptr(),
           B, Ci, Co, H, W, int(relu))
    return y


def conv3x3_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    relu: bool = False) -> torch.Tensor:
    """K2: y = conv(x, weight) + bias [ReLU]; no autograd graph."""
    if not use_kernel(x, weight, bias):
        return conv3x3_plain(x, weight, bias, relu)
    y = _launch_forward(x, weight, bias, relu)
    conv3x3.launches += 1
    return y


def conv3x3_dx(dy: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K2 as the conv's dx: dy (B, Co, H, W), weight (Co, Ci, 3, 3) →
    dx (B, Ci, H, W) in dy's type."""
    if not use_kernel(dy, weight):
        return conv3x3_dx_plain(dy, weight)
    zero = torch.zeros(weight.shape[1], dtype=torch.float32, device=dy.device)
    dx = _launch_forward(dy, _rot180_t(weight), zero, False)
    conv3x3_dx.launches += 1
    return dx


def conv3x3_dk(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K3: x (B, Ci, H, W), dy (B, Co, H, W) → dk (Co, Ci, 3, 3) float32.
    Deterministic: two runs give the same bits."""
    if not use_kernel(x, dy):
        return conv3x3_dk_plain(x, dy)
    if x.dtype not in _DK_ENTRY or dy.dtype != x.dtype:
        raise TypeError(f"conv3x3_dk kernel takes x and dy both float32 or both "
                        f"bfloat16, got {x.dtype} and {dy.dtype}")
    B, Ci, H, W = x.shape
    Co = dy.shape[1]
    if dy.shape != (B, Co, H, W):
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)}")
    x, dy = x.contiguous(), dy.contiguous()
    entry, chunks = _DK_ENTRY[x.dtype]
    n_chunks = getattr(library(), chunks)(B, Ci, Co, H, W)
    partial = torch.empty((n_chunks, Co, Ci, 9), dtype=torch.float32, device=x.device)
    dk = torch.empty((Co, Ci, 3, 3), dtype=torch.float32, device=x.device)
    launch(entry, x.device, x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
           dk.data_ptr(), B, Ci, Co, H, W, n_chunks)
    conv3x3_dk.launches += 1
    return dk


class _Conv3x3(torch.autograd.Function):
    """The conv's VJP, as the JAX package's ``_conv_bwd``: under a fused ReLU
    dy ← dy·(y > 0); dx by K2 on the rotated, transposed weight (only when x
    needs a gradient); dk by K3; db = Σ dy in float32."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        x = x.contiguous()
        y = conv3x3_forward(x, weight, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, y = ctx.saved_tensors
        if ctx.relu:
            dy = dy * (y > 0).to(dy.dtype)
        dy = dy.contiguous()
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dx(dy, weight)
        if ctx.needs_input_grad[1]:
            dk = conv3x3_dk(x, dy).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum((0, 2, 3)).to(weight.dtype)
        return dx, dk, db, None


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """x (B, Ci, H, W); weight (Co, Ci, 3, 3); bias (Co,) → (B, Co, H, W),
    differentiable in all three. A CPU input runs the plain versions, a CUDA
    input launches the kernels; a non-contiguous input is copied first."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, Ci, H, W), got {tuple(x.shape)}")
    Ci = x.shape[1]
    Co = weight.shape[0]
    if weight.shape != (Co, Ci, 3, 3) or bias.shape != (Co,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not fit "
            f"Ci={Ci}")
    return _Conv3x3.apply(x, weight, bias, relu)


conv3x3.launches = 0
conv3x3_dx.launches = 0
conv3x3_dk.launches = 0
