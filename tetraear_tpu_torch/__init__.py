"""tetraear_tpu_torch: the TETRA receive chain in PyTorch + CUDA.

A port of ``tetraear_tpu`` (JAX, Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA Hopper card (sm_90a): the fused
wideband receive path and the classic chain (conv or fft frontend, any
supported rate, per-carrier AFC), from IQ to CRC-checked frames.
``tetraear_tpu`` stays the reference: the tests in
``tests/test_torch_*.py`` hold every module here against its JAX
counterpart on the CPU.

This package imports ``torch`` and never ``jax``, and nothing of
``tetraear_tpu``: it keeps its own copies of the host modules it needs
(``frame``, ``dsp.design``, ``ref``, ``runtime.sources``,
``crypto.tea``, ``utils.logging``).  Its entry points run on the card
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``;
see ``device.resolve``).

Float32 matmuls run in full precision: TF32 is switched off for both
matmul and cuDNN here, so the plain versions of the kernels are float32
references on the card as on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
