"""Tables and carried state across the JAX reference and the port.

Both packages keep the same layouts (complex values as float32
[re, im] pairs, the fused state tree of dsp/backhalf.py), so carrying
state across is a selection of the keys the port uses plus a change of
array type.  Inputs are numpy arrays (``np.asarray`` of a JAX array),
so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# the channelizer tables the fused receive path reads
TABLE_NAMES = ("h1_planes", "row_start", "d_shift", "m1c", "m2re", "m2im",
               "twre", "twim", "cycle_step")


def _t(a, device):
    # a copy: arrays taken from JAX are read-only
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def tables_from_jax(ch, device="cpu") -> dict:
    """A JAX ``FFTChannelizer``'s numpy tables as the port's tensors."""
    return {name: _t(getattr(ch, name), device) for name in TABLE_NAMES}


def state_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX ``FusedRx`` state (as numpy) -> the port's state.  The
    classic chain's registers (nco_cycles, stage_hist, rrc_hist, afc_*)
    are not used by the fused path and are dropped."""
    bank = tree["bank"]
    tim = bank["timing"]
    return {
        "bank": {
            "channelizer": {
                "tail": _t(bank["channelizer"]["tail"], device),
                "cycles": _t(bank["channelizer"]["cycles"], device),
            },
            "timing": {key: _t(tim[key], device)
                       for key in ("tail", "next_t", "acc")},
            "prev_sym": _t(bank["prev_sym"], device),
        },
        "bit_tail": _t(tree["bit_tail"], device),
    }


def state_to_numpy(state: dict) -> dict:
    """The port's state as a tree of numpy arrays (same keys)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy()
