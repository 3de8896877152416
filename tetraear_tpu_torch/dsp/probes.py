"""Measurement instruments on the card, each a hand-written CUDA
kernel (csrc/probes.cu) with a plain PyTorch version:

  ``bit_place``      the fused back half's bit placement alone
                     (perf/place_probe.py times the TPU kernel's
                     placement matmul chain alone)
  ``ops_probe``      one elementwise operation or layout idiom a launch,
                     held against the PyTorch operation
                     (perf/mosaic_ops_probe.py asks which operations a
                     TPU kernel may use)
  ``iir_recursion``  a serial sample recursion inside one kernel against
                     the same recursion driven from the host step by step
                     (perf/scan_overhead_probe.py)
  ``int_rate``       a register-only loop of 32-bit logic operations,
                     additions or population counts: the card's integer
                     instruction rates,
                     which price the frame scan's bound (no TPU
                     counterpart; chip_smoke.py's yardstick)

No decode path calls them: ``chip_smoke.py`` drives each, holds it
against its plain version and times both.  Build, dispatch rule (CPU
tensors run the plain version, CUDA tensors launch the kernel or raise)
and launch counts are ``cuda_kernels``'.
"""

from __future__ import annotations

import torch

from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.dsp.cuda_kernels import (TAILBITS, _check, _launch,
                                                 _ptr, _route)

# ---------------------------------------------------------------------------
# probe 1: bit placement of the fused back half
# ---------------------------------------------------------------------------


def bit_place(hard: torch.Tensor, bt: torch.Tensor, dsel: torch.Tensor,
              k_max: int, z_rows: int) -> tuple:
    """The scan row and the next carried tail from the symbol decisions.

    hard (C, NS) uint8, 2 msb + lsb of symbol i and 0 where the symbol is
    not valid; bt (C, TR, 128) f32 {0,1} carried tail bits (the first
    1200 are read); dsel (C,) int32.  Returns (z (C, 4 z_rows) int32,
    the row's bits packed LSB first: the tail, then the two bits of
    symbol i at 1200 + 2i, msb first; bt2 (C, TR, 128) f32 with
    bt2[c, pos] = bit 2 k_max - 4 + 2 dsel[c] + pos of the row for
    pos < 1200).

    Replaces the placement kernels of perf/place_probe.py (the five-class
    E @ (pm @ F) chain of the TPU back half).  Bound: device memory (NS
    bytes and 2 TR rows of 512 bytes per carrier).  Design: the device
    functions of csrc/place.cuh exactly as csrc/backhalf.cu runs them, one
    block a carrier: ballot packing of the tail, 16 symbols a word, a bit
    gather for the next tail."""
    c = hard.shape[0] if hard.dim() == 2 else -1
    ns = hard.shape[1] if hard.dim() == 2 else -1
    tr = bt.shape[1] if bt.dim() == 3 else -1
    _check(hard, "hard", (c, ns), torch.uint8)
    _check(bt, "bt", (c, tr, 128), torch.float32)
    _check(dsel, "dsel", (c,), torch.int32)
    if tr * 128 < TAILBITS:
        raise ValueError(f"bt holds {tr * 128} < {TAILBITS} tail bits")
    if z_rows * 128 < TAILBITS + 2 * ns:
        raise ValueError(f"{z_rows} rows of 128 bits cannot hold "
                         f"{TAILBITS} + 2 * {ns}")
    if _route(hard, bt, dsel) == "cpu":
        return bit_place_plain(hard, bt, dsel, k_max, z_rows)
    dev = hard.device
    lib = ck.build()
    z = torch.empty((c, 4 * z_rows), dtype=torch.int32, device=dev)
    bt2 = torch.empty((c, tr, 128), dtype=torch.float32, device=dev)
    _launch("bit_place", dev, lib.tt_bit_place, _ptr(hard), _ptr(bt),
            _ptr(dsel), _ptr(z), _ptr(bt2), ns, 4 * z_rows, int(k_max), tr,
            c)
    return z, bt2


def bit_place_plain(hard, bt, dsel, k_max, z_rows):
    """Plain version of bit_place: the bit row as fused_backhalf_plain
    lays it out, packed with a weighted sum."""
    c, ns = hard.shape
    dev = hard.device
    tr = bt.shape[1]
    zb = z_rows * 128
    bits = torch.zeros((c, zb), dtype=torch.int64, device=dev)
    bits[:, :TAILBITS] = (bt.reshape(c, -1)[:, :TAILBITS] != 0).long()
    h = hard.long()
    bits[:, TAILBITS:TAILBITS + 2 * ns:2] = h >> 1
    bits[:, TAILBITS + 1:TAILBITS + 2 * ns:2] = h & 1
    weights = torch.ones(32, dtype=torch.int64, device=dev) << torch.arange(
        32, device=dev)
    words = (bits.reshape(c, zb // 32, 32) * weights).sum(dim=2)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    off = 2 * int(k_max) - 4 + 2 * dsel.long()
    src = off[:, None] + torch.arange(TAILBITS, device=dev)[None, :]
    padded = torch.cat([bits, torch.zeros((c, TAILBITS), dtype=torch.int64,
                                          device=dev)], dim=1)
    bt2 = torch.zeros((c, tr * 128), dtype=torch.float32, device=dev)
    bt2[:, :TAILBITS] = torch.gather(padded, 1, src).to(torch.float32)
    return words.to(torch.int32), bt2.reshape(c, tr, 128)


# ---------------------------------------------------------------------------
# probe 2: elementwise operations and layout idioms
# ---------------------------------------------------------------------------

# name -> (operation number of csrc/probes.cu, plain version, exact)
OPS = {
    "cos": (0, lambda a, b: torch.cos(a), False),
    "sin": (1, lambda a, b: torch.sin(a), False),
    "floor": (2, lambda a, b: torch.floor(a), True),
    "mod": (3, lambda a, b: torch.remainder(a, b), False),
    "arctan2": (4, lambda a, b: torch.atan2(a, b), False),
    "exp": (5, lambda a, b: torch.exp(a), False),
    "rsqrt": (6, lambda a, b: torch.rsqrt(a), False),
    "round": (7, lambda a, b: torch.round(a), True),
    "sign_select": (8, lambda a, b: torch.where(a < 3.0, a, -a), True),
    "bcast_col": (9, lambda a, b: a * b[:, None], True),
    "iota_sel_mm": (10, lambda a, b: a @ _selector(a), True),
    "scalar_red_row": (11, lambda a, b: _red_row(a), False),
}
_COLUMN_OPS = ("bcast_col",)
_UNARY_OPS = ("cos", "sin", "floor", "exp", "rsqrt", "round", "sign_select",
              "iota_sel_mm", "scalar_red_row")


def _selector(a: torch.Tensor) -> torch.Tensor:
    """(cols, cols / 4) matrix with 2 at [4u + 3, u]."""
    cols = a.shape[1]
    lam = torch.arange(cols, device=a.device)[:, None]
    u = torch.arange(cols // 4, device=a.device)[None, :]
    return torch.where(lam == 4 * u + 3, 2.0, 0.0).to(a.dtype)


def _red_row(a: torch.Tensor) -> torch.Tensor:
    row = torch.zeros(128, dtype=a.dtype, device=a.device)
    row[0] = a.sum()
    row[1] = (a * a).sum()
    return row


def ops_probe(op: str, a: torch.Tensor,
              b: torch.Tensor | None = None) -> torch.Tensor:
    """One elementwise operation or layout idiom of ``OPS`` on a
    (rows, cols) float32 tensor ``a``; ``b`` is a second (rows, cols)
    operand (mod, arctan2), a (rows,) column (bcast_col) or absent.
    Returns (rows, cols) float32; (rows, cols / 4) for iota_sel_mm (the
    product with the selector that picks column 4u + 3 twice over);
    (128,) for scalar_red_row (the sum in lane 0, the sum of squares in
    lane 1).

    Replaces the one-operation kernels of perf/mosaic_ops_probe.py.
    There the question is which operations the TPU compiler lowers; on
    this card every one compiles, and the question is how the device's
    math functions, built without multiply-add contraction as the back
    half is, agree with the PyTorch operation a plain version uses.
    Bound: launch latency (1024 elements).  Design: one kernel with the
    operation as an argument, a thread an element; the reduction is one
    block with a shuffle tree."""
    if op not in OPS:
        raise ValueError(f"ops_probe: unknown operation {op!r}")
    rows = a.shape[0] if a.dim() == 2 else -1
    cols = a.shape[1] if a.dim() == 2 else -1
    _check(a, "a", (rows, cols), torch.float32)
    if op in _UNARY_OPS:
        if b is not None:
            raise ValueError(f"ops_probe: {op} takes one operand")
    else:
        _check(b, "b", (rows,) if op in _COLUMN_OPS else (rows, cols),
               torch.float32)
    if op == "iota_sel_mm" and cols % 4:
        raise ValueError(f"iota_sel_mm needs 4 | cols (got {cols})")
    number, plain, _ = OPS[op]
    if _route(*((a,) if b is None else (a, b))) == "cpu":
        return plain(a, b)
    dev = a.device
    lib = ck.build()
    shape = {"iota_sel_mm": (rows, cols // 4),
             "scalar_red_row": (128,)}.get(op, (rows, cols))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _launch("ops_probe", dev, lib.tt_ops_probe, number, _ptr(a),
            _ptr(b) if b is not None else None, _ptr(out), rows, cols)
    return out


def ops_probe_plain(op: str, a, b=None):
    """Plain version of ops_probe: the PyTorch operation."""
    return OPS[op][1](a, b)


# ---------------------------------------------------------------------------
# probe 3: a serial sample recursion inside one kernel
# ---------------------------------------------------------------------------

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -2 ** 31


def iir_recursion(a: torch.Tensor, x: torch.Tensor) -> tuple:
    """The speech decoder's 10-tap saturating synthesis filter
    (voice/jspeech ``_syn_filt_step`` of the reference, in the ETSI basic
    operations) over n samples of B independent rows.

    a (B, 10) int32 coefficients, x (n, B) int32 excitation.  Per sample
    and row: L = (x << 16) >> 4; L = L_sub(L, a[k] * m[k]) for k = 0..9
    (saturating); y = the low 16 bits of L >> 12, sign-extended; m = [y,
    m[0..8]].  Returns (y (n, B) int32, m (B, 10) int32 after the last
    sample).

    Replaces the in-kernel ``fori_loop`` of perf/scan_overhead_probe.py.
    Bound: integer operations (about 75 a sample and row), then 8 n B
    bytes.  Design: one thread a row, coefficients and filter memory in
    registers, the n samples a loop inside the kernel, x read and y
    written coalesced across rows.  The plain version runs the same
    recursion from the host, a few dozen small launches a sample: the
    difference between the two times is what a launch-per-step form
    costs on this card."""
    b = a.shape[0] if a.dim() == 2 else -1
    n = x.shape[0] if x.dim() == 2 else -1
    _check(a, "a", (b, 10), torch.int32)
    _check(x, "x", (n, b), torch.int32)
    if _route(a, x) == "cpu":
        return iir_recursion_plain(a, x)
    dev = a.device
    lib = ck.build()
    y = torch.empty((n, b), dtype=torch.int32, device=dev)
    m = torch.empty((b, 10), dtype=torch.int32, device=dev)
    _launch("iir_recursion", dev, lib.tt_iir_recursion, _ptr(a), _ptr(x),
            _ptr(y), _ptr(m), n, b)
    return y, m


def iir_recursion_plain(a, x):
    """Plain version of iir_recursion: the recursion driven step by step
    in int64, with the wraps and saturations of the basic operations
    written out."""
    n, b = x.shape
    a64 = a.long()
    m = torch.zeros((b, 10), dtype=torch.int64, device=a.device)
    ys = []
    for i in range(n):
        acc = (x[i].long() << 16) & 0xFFFFFFFF
        acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc) >> 4
        for k in range(10):
            acc = torch.clamp(acc - a64[:, k] * m[:, k], _I32_MIN, _I32_MAX)
        y = (acc >> 12) & 0xFFFF
        y = torch.where(y >= 2 ** 15, y - 2 ** 16, y)
        m = torch.cat([y[:, None], m[:, :-1]], dim=1)
        ys.append(y)
    return (torch.stack(ys).to(torch.int32) if ys
            else torch.zeros((0, b), dtype=torch.int32, device=a.device),
            m.to(torch.int32))


# ---------------------------------------------------------------------------
# the integer instruction rates (the yardstick of the scan's bound)
# ---------------------------------------------------------------------------

INT_RATE_MASK = 0x5DEECE66
INT_RATE_KINDS = ("logic", "popc", "add")


def int_rate(kind: str, iters: int, out: torch.Tensor) -> torch.Tensor:
    """Run ``iters`` rounds of eight dependent-free integer operations in
    each of out.numel() threads and store each thread's folded registers
    into ``out`` ((n,) int32, n a multiple of 256).  ``kind`` "logic": a
    round is eight three-input logic operations r_i = (r_i & mask) ^
    r_{i+1}; "add": eight three-input additions r_i + mask + r_{i+1};
    "popc": eight population counts, each followed by one exclusive-or.
    8 * iters * n operations over the kernel's time is the
    card's rate for that instruction; chip_smoke.py times it and prices
    the scan's bound with the two rates.

    Bound: integer operations, by construction (one 4-byte store a
    thread).  Design: csrc/probes.cu, eight independent registers a
    thread so that the pipeline stays full."""
    if kind not in INT_RATE_KINDS:
        raise ValueError(f"int_rate: unknown kind {kind!r}")
    n = out.numel()
    _check(out, "out", (n,), torch.int32)
    if n % 256 or iters < 0:
        raise ValueError(f"int_rate: {n} threads (a multiple of 256), "
                         f"{iters} rounds")
    if _route(out) == "cpu":
        out.copy_(int_rate_plain(kind, iters, n))
        return out
    lib = ck.build()
    _launch("int_rate", out.device, lib.tt_int_rate,
            INT_RATE_KINDS.index(kind), int(iters), INT_RATE_MASK,
            _ptr(out), n)
    return out


def int_rate_plain(kind: str, iters: int, n: int) -> torch.Tensor:
    """Plain version of int_rate: the same rounds in int64 tensors."""
    m32 = 0xFFFFFFFF
    tid = torch.arange(n, dtype=torch.int64)
    r = [((tid + 1) * 2654435761 + 40503 * i) & m32 for i in range(8)]

    def popc(v):
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return ((v * 0x01010101) & m32) >> 24

    for _ in range(iters):
        for i in range(8):
            nxt = r[(i + 1) & 7]
            if kind == "add":
                r[i] = (r[i] + INT_RATE_MASK + nxt) & m32
            else:
                r[i] = ((r[i] & INT_RATE_MASK) if kind == "logic"
                        else popc(r[i])) ^ nxt
    acc = r[0]
    for v in r[1:]:
        acc = acc ^ v
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
    return acc.to(torch.int32)
