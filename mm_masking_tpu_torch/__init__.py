"""mm_masking_tpu_torch — PyTorch/CUDA port of ``mm_masking_tpu``.

The JAX package beside it is the reference: module paths and public names
mirror it one to one (``mm_masking_tpu.dicp.icp`` ↔
``mm_masking_tpu_torch.dicp.icp``), and the tests feed both the same numpy
inputs. Plain tensor code is PyTorch; each Pallas kernel of the JAX package
becomes a CUDA C++ kernel for Hopper under ``csrc/``, built with ``nvcc`` at
first use and bound through ``ctypes`` (``ops/kernels``).

This slice covers the policy's inference step: batch-global normalisation →
UNet mask → per-point weight lookup → tolerance-stopped stripe ICP → error
triple (``train.trainer.Trainer.eval_step``).

Geometry runs in float32: TF32 is switched off for matmuls and for cuDNN
convolutions at import, because reduced-precision distances pick wrong
nearest neighbours (the JAX package's ``ops/pallas/nn_assoc.py`` note).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
