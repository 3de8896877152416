"""Batched ETSI speech channel decoding (tetraear_tpu/voice/jviterbi.py).

A block's voice candidates are channel-decoded together: (B, 432) soft
bits -> 2 x 137 speech-frame bits and a bad-frame flag a block, bit-exact
against the C++ decoder (voice/csrc/channel.cpp).  Per block:

  * deinterleave (``_REINT``); class 0 is the sign of the first 102;
  * a 16-state Viterbi over the 184-step punctured RCPC trellis: int32
    path metrics, 0 for state 0 and -(1 << 28) for the others at the
    start, the branch metric of post-state ns from predecessor parity p
    is sum_j r_j * sign[ns, p, j] over the step's received values
    (punctured ones are 0), and the odd predecessor wins only when its
    metric is strictly greater;
  * traceback from state 0 (bit = state >> 3, prev = 2 * (state & 7) +
    parity);
  * the CRC-8 recheck of ordered[214:282] against ``_CRC_M`` -> BFI.

``decode`` is the kernel wrapper: on CUDA tensors it launches the
hand-written ``viterbi_decode`` kernel (dsp/csrc/viterbi.cu, one
half-warp a block, its table uploaded once a device, built with the
other kernels by dsp.cuda_kernels, one count in
``cuda_kernels.launches["viterbi_decode"]`` a launch), on CPU tensors it
runs ``decode_plain``, the same steps in plain PyTorch.
``channel_decode_batch`` is the host entry of the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.voice import etsi_tables as T

_STATES = 16
SOFT_BITS = 432
ORDERED_BITS = T.N0 + T.STEPS          # 286


def _expected_signs() -> np.ndarray:
    """(16, 2, 3) int32: for post-state ns and predecessor parity p, the
    expected +-1 symbol of V1/V2/V3 (window w = (ns<<1)|p)."""
    e = np.zeros((_STATES, 2, 3), np.int32)
    for ns in range(_STATES):
        for p in range(2):
            w = (ns << 1) | p
            for j, g in enumerate((T.G1, T.G2, T.G3)):
                e[ns, p, j] = -1 if T.parity(w & g) else 1
    return e


def _code_step_index() -> tuple:
    """(STEPS, 3) index into the 330-bit code stream (post-class-0) for
    each step's V1/V2/V3, and the (STEPS, 3) presence mask."""
    pres = T.puncture_schedule()
    idx = np.zeros((T.STEPS, 3), np.int32)
    j = 0
    for i in range(T.STEPS):
        for s in range(3):
            if pres[i, s]:
                idx[i, s] = j
                j += 1
    return idx, pres


_DEINT = T.interleave_index()          # transmitted[i] = encoded[DEINT[i]]
_REINT = np.argsort(_DEINT)            # encoded[k] = transmitted[REINT[k]]
_SIGNS = _expected_signs()
_STEP_IDX, _STEP_PRES = _code_step_index()
_CRC_M = T.crc_matrix()
# predecessors of post-state ns: s0 = 2*(ns & 7), s1 = s0 + 1
_PRED0 = np.array([2 * (ns & 7) for ns in range(_STATES)], np.int32)

# the kernel's table (csrc/viterbi.cu), one int32 tensor uploaded once a
# device: for each step its three positions in the deinterleaved row
# (SOFT_BITS, a zero pad, where punctured) as pos0 | pos1 << 10 | pos2 <<
# 20; for each state ns its branch sum for parity p as one of the step's
# four sums q[idx] = r0 +- r1 +- r2 (bit 1 of idx: r1 subtracted, bit 0:
# r2) times +-1, packed idx0 | neg0 << 2 | idx1 << 3 | neg1 << 5; then
# each CRC check's taps over ordered[214:282] as three 32-bit words
_K_POS = np.where(_STEP_PRES > 0, T.N0 + _STEP_IDX, SOFT_BITS)
_K_STEP = (_K_POS[:, 0] | _K_POS[:, 1] << 10 | _K_POS[:, 2] << 20)
_K_SUM_IDX = (((_SIGNS[:, :, 1] != _SIGNS[:, :, 0]) << 1)
              | (_SIGNS[:, :, 2] != _SIGNS[:, :, 0]))         # (16, 2)
_K_SUM_NEG = _SIGNS[:, :, 0] < 0
_K_LANE = (_K_SUM_IDX[:, 0] | _K_SUM_NEG[:, 0] << 2
           | _K_SUM_IDX[:, 1] << 3 | _K_SUM_NEG[:, 1] << 5)
_K_CRC = np.zeros((8, 3), np.uint32)
for _k, _q in zip(*np.nonzero(_CRC_M)):
    _K_CRC[_k, _q >> 5] |= np.uint32(1 << (_q & 31))
_K_TABLE = np.concatenate([_K_STEP.astype(np.int32),
                           _K_LANE.astype(np.int32),
                           _K_CRC.reshape(-1).view(np.int32)])
_TABLE_ON: dict = {}


def table_on(dev: torch.device) -> torch.Tensor:
    """The kernel's table on ``dev``, uploaded on the first call there."""
    key = str(dev)
    if key not in _TABLE_ON:
        _TABLE_ON[key] = torch.from_numpy(_K_TABLE).to(dev)
    return _TABLE_ON[key]


def cta_warps(b: int, n_sms: int) -> int:
    """Warps a CTA of the kernel for ``b`` blocks (two a warp): the
    fewest of 1, 2, 4 that leave at most two CTAs an SM, so that a small
    batch spreads over the SMs; 4 beyond that."""
    warps = -(-b // 2)
    return next((w for w in (1, 2) if -(-warps // w) <= 2 * n_sms), 4)


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[key]


def kernel_args(soft: torch.Tensor, ordered: torch.Tensor,
                bfi: torch.Tensor) -> tuple:
    """The C entry's arguments but the stream: device pointers and
    integers only (the table is on the card), what ``decode`` launches
    and ``chip_smoke.py`` times alone."""
    dev = soft.device
    b = soft.shape[0]
    return (ck._ptr(soft), ck._ptr(table_on(dev)), ck._ptr(ordered),
            ck._ptr(bfi), b, cta_warps(b, _sm_count(dev)))


def decode_plain(soft: torch.Tensor) -> tuple:
    """Plain version of ``decode``: a loop of 184 tensor steps over
    (B, 16) int32 metrics, and a reverse loop for the traceback."""
    dev = soft.device
    b = soft.shape[0]
    soft = soft.to(torch.int32)
    de = soft[:, torch.from_numpy(_REINT).to(dev)]       # deinterleave
    class0 = (de[:, :T.N0] < 0).to(torch.uint8)
    code = de[:, T.N0:]                                   # (B, 330)
    r = (code[:, torch.from_numpy(_STEP_IDX).to(dev)]
         * torch.from_numpy(_STEP_PRES).to(dev))          # (B, STEPS, 3)
    signs = torch.from_numpy(_SIGNS).to(dev)              # (16, 2, 3)
    pred0 = torch.from_numpy(_PRED0).long().to(dev)
    metrics = torch.full((b, _STATES), -(1 << 28), dtype=torch.int32,
                         device=dev)
    metrics[:, 0] = 0
    decisions = []
    for i in range(T.STEPS):
        r_i = r[:, i]                                     # (B, 3)
        bm = (r_i[:, None, None, :] * signs[None]).sum(-1,
                                                       dtype=torch.int32)
        c0 = metrics[:, pred0] + bm[:, :, 0]
        c1 = metrics[:, pred0 + 1] + bm[:, :, 1]
        take1 = c1 > c0                    # strict: ties keep the even one
        metrics = torch.where(take1, c1, c0)
        decisions.append(take1)
    state = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    bits = []
    for i in range(T.STEPS - 1, -1, -1):
        bits.append((state[:, 0] >> 3).to(torch.uint8))
        par = decisions[i].gather(1, state).long()
        state = 2 * (state & 7) + par
    conv = torch.stack(bits[::-1], dim=1) if b else torch.zeros(
        (0, T.STEPS), dtype=torch.uint8, device=dev)
    ordered = torch.cat([class0, conv], dim=1)            # (B, 286)
    c2crc = ordered[:, 214:282].to(torch.int32)
    crc_m = torch.from_numpy(_CRC_M.astype(np.int32)).to(dev)
    syndrome = (c2crc[:, None, :] * crc_m[None]).sum(-1) & 1
    return ordered, (syndrome != 0).any(dim=1)


def decode(soft: torch.Tensor) -> tuple:
    """(B, 432) int32 soft bits (transmitted order) -> (ordered (B, 286)
    uint8: class 0 ++ the 184 decoded bits, bfi (B,) bool).

    Replaces the reference's ``channel_decode_batch_traced`` (an XLA
    lax.scan).  Bound: integer instructions at large B (about 150 a
    trellis step), the latency of one block's chain at the live path's
    B.  Design: dsp/csrc/viterbi.cu, one half-warp a block, lanes as
    states, each step's four branch sums computed ahead of the forward
    pass, predecessors by shuffle, decisions by ballot into shared memory,
    the traceback as a history register, the table resident on the card,
    a CTA of 1-4 warps by B."""
    b = soft.shape[0] if soft.dim() == 2 else -1
    ck._check(soft, "soft", (b, SOFT_BITS), torch.int32)
    if ck._route(soft) == "cpu":
        return decode_plain(soft)
    dev = soft.device
    ordered = torch.empty((b, ORDERED_BITS), dtype=torch.uint8, device=dev)
    bfi = torch.empty((b,), dtype=torch.bool, device=dev)
    if b:
        if soft.data_ptr() % 16:
            raise ValueError("soft: storage must be 16-byte aligned")
        ck._launch("viterbi_decode", dev, ck.build().tt_viterbi,
                   *kernel_args(soft, ordered, bfi))
    return ordered, bfi


def _unbuild(ordered: np.ndarray) -> np.ndarray:
    """(B, 286) ordered -> (B, 2, 137) frame bits (A, B)."""
    b = ordered.shape[0]
    frames = np.zeros((b, 2, 137), np.uint8)
    pos = np.concatenate([T.TAB0, T.TAB1, T.TAB2]) - 1
    # ordered pairs: [2k] frame A, [2k+1] frame B, k over TAB0|TAB1|TAB2
    frames[:, 0, pos] = ordered[:, 0:274:2]
    frames[:, 1, pos] = ordered[:, 1:274:2]
    return frames


def channel_decode_batch(soft: np.ndarray, device=None) -> dict:
    """Host entry: (B, 432) soft blocks -> frames + BFI, decoded on
    ``device`` (None: the card).

    Returns {"frames": (B, 2, 137) uint8, "bfi": (B,) bool}."""
    soft = np.atleast_2d(np.asarray(soft, np.int32))
    ordered, bfi = decode(torch.from_numpy(soft).to(resolve(device)))
    return {"frames": _unbuild(ordered.cpu().numpy()),
            "bfi": bfi.cpu().numpy()}
