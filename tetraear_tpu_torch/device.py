"""The one place the port picks its device.

Every entry point (``PipelineConfig.device``, ``--device``, ``FusedRx``,
``ClassicRx``, ``DecodeRunner``, ``init_state``, ``convert``) takes
``device=None`` and passes it through ``resolve``: no device given means
the card, and a machine without one raises.  Nothing falls back to the
CPU; callers that want the CPU (the tests do) say ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``torch.device`` for ``device``; ``None`` is the CUDA card.

    Raises RuntimeError when the card is asked for (by ``None`` or by
    name) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tetraear_tpu_torch runs on an NVIDIA GPU unless the caller "
            "asks for the CPU (device=\"cpu\" / --device cpu), and "
            "torch.cuda.is_available() is False on this machine")
    return dev
