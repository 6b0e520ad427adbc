"""mm_masking_tpu_torch — PyTorch/CUDA port of ``mm_masking_tpu``.

The JAX package beside it is the reference: module paths and public names
mirror it one to one (``mm_masking_tpu.dicp.icp`` ↔
``mm_masking_tpu_torch.dicp.icp``), and the tests feed both the same numpy
inputs. Plain tensor code is PyTorch; each Pallas kernel of the JAX package
becomes a CUDA C++ kernel for Hopper under ``csrc/``, built with ``nvcc`` at
first use and bound through ``ctypes`` (``ops/kernels``).

Ported so far: the policy's inference and train steps (batch-global
normalisation → UNet mask → per-point weight lookup → stripe ICP → error
triple or loss, ``train.trainer.Trainer``), the motion-gated eval solve,
the data path over the converted Boreas layout (``data``), the
evaluation harness (``evaluation``), localization (``localization``: the
teach pass, datagen and the localize CLI, with the radar detectors and
point-cloud preprocessing under ``ops``), continuous-time odometry
(``dicp.ct_icp``, ``geom.gp_interp``), MC-RANSAC with its descriptors
(``ops.mcransac``, ``ops.descriptors``) and the policy's polar network
input and output.

Geometry runs in float32: TF32 is switched off for matmuls and for cuDNN
convolutions at import, because reduced-precision distances pick wrong
nearest neighbours (the JAX package's ``ops/pallas/nn_assoc.py`` note).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
