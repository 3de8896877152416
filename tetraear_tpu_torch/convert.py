"""Tables and carried state across the JAX reference and the port.

Both packages keep the same layouts (complex values as float32
[re, im] pairs, the state trees of dsp/pipeline.py and dsp/backhalf.py),
so carrying state across is a change of array type, key by key.
Inputs are numpy arrays (``np.asarray`` of a JAX array), so this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve

# the channelizer tables the block steps read (those a geometry lacks
# are skipped: d_shift and the synthesis tables need row-gatherable
# bands, h1_roll and ramp the quantized extraction)
TABLE_NAMES = ("h1_planes", "row_start", "d_shift", "m1c", "m2re", "m2im",
               "twre", "twim", "cycle_step", "band_start", "row_idx",
               "h1_band", "h1_roll", "ramp", "sign", "_m1", "_tw", "_m2")


def _t(a, device):
    # a copy: arrays taken from JAX are read-only
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def tables_from_jax(ch, device=None) -> dict:
    """A JAX ``FFTChannelizer``'s numpy tables as the port's tensors."""
    device = resolve(device)
    return {name: _t(getattr(ch, name), device) for name in TABLE_NAMES
            if hasattr(ch, name)}


def state_from_jax(tree, device=None):
    """A JAX carried state (a tree of dicts and lists of numpy arrays)
    -> the port's state.

    Takes a ``CarrierBankDemod`` state (channelizer ``tail``/``cycles``,
    ``nco_cycles``, ``stage_hist``, ``rrc_hist``, ``timing``,
    ``prev_sym``, ``afc_omega``, ``afc_phase``) or a ``FusedRx`` state
    ({"bank": ..., "bit_tail": ...}): every key is carried, so both
    packages compute the same thing from the same state."""
    device = resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _t(node, device)

    return walk(tree)


def tail_bits_from_jax(tail_bits, device=None) -> torch.Tensor:
    """The JAX ``DecodeRunner``'s carried (C, 2T) uint8 bit tail."""
    return _t(np.asarray(tail_bits, np.uint8), resolve(device))


def state_to_numpy(state):
    """The port's state as a tree of numpy arrays (same keys)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [state_to_numpy(v) for v in state]
    return state.detach().cpu().numpy()
