"""tetraear_tpu_torch: the TETRA fleet receive path in PyTorch + CUDA.

A port of the fused wideband receive path of ``tetraear_tpu`` (JAX,
Pallas on a TPU) to PyTorch with hand-written CUDA kernels for an
NVIDIA Hopper card (sm_90a).  ``tetraear_tpu`` stays the reference:
the tests in ``tests/test_torch_*.py`` hold every module here against
its JAX counterpart on the CPU.

This package imports ``torch`` and never ``jax``.  It shares the
jax-free host modules of ``tetraear_tpu`` (``frame``, ``dsp.design``,
``ref``, ``runtime.sources``, ``crypto.tea``).

Float32 matmuls run in full precision: TF32 is switched off for both
matmul and cuDNN here, so the plain versions of the kernels are float32
references on the card as on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
