"""ETSI basicop fixed-point arithmetic on PyTorch tensors.

The saturating Word16 / Word32 operator set of voice/csrc/etsi_dsp.h
(the classic ETSI / ITU-T basicops the TETRA codec is specified in),
with the JAX package's names (tetraear_tpu/voice/jfixed.py), for the
plain version of the batched ACELP decoder (voice/speech.py).

Values ride in int64 tensors: Word16 values in [-32768, 32767], Word32
values in the int32 range.  A sum, difference, product or left shift is
computed exactly in int64 and then saturated (clamped), which is the
basicops' overflow rule: L_add saturates exactly when the true sum
leaves int32, and L_shl's progressive saturation exactly when the true
product by 2^n does.  ``>>`` is arithmetic on signed tensors, as in
the reference.  Inputs may be Python ints or int32 / int64 tensors; a
result is an int64 tensor, or an int where every input was one.

The global Overflow / Carry flags are not modelled: the decoder never
reads them.
"""

from __future__ import annotations

import torch

I16_MIN = -0x8000
I16_MAX = 0x7FFF
I32_MIN = -0x80000000
I32_MAX = 0x7FFFFFFF

_i64 = torch.int64


def _c(x):
    """An int stays an int; a tensor becomes int64 (values in range)."""
    if isinstance(x, torch.Tensor) and x.dtype != _i64:
        return x.to(_i64)
    return x


def _t(x) -> torch.Tensor:
    """Int or tensor -> int64 tensor."""
    return torch.as_tensor(_c(x), dtype=_i64)


def _clamp(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor):
        return x.clamp(lo, hi)
    return max(lo, min(hi, x))


# ---- Word16 ops ----------------------------------------------------------

def sature(L):
    """Clamp a Word32 to the Word16 range."""
    return _clamp(_c(L), I16_MIN, I16_MAX)


def add(a, b):
    return sature(_c(a) + _c(b))


def sub(a, b):
    return sature(_c(a) - _c(b))


def abs_s(a):
    a = _t(a)
    return torch.where(a == I16_MIN, I16_MAX, a.abs())


def negate(a):
    a = _t(a)
    return torch.where(a == I16_MIN, I16_MAX, -a)


def extract_h(L):
    """High 16 bits, sign-extended (arithmetic >> 16)."""
    return _c(L) >> 16


def extract_l(L):
    """Low 16 bits, sign-extended (wraps, no saturation)."""
    return ((_c(L) + 0x8000) & 0xFFFF) - 0x8000


def mult(a, b):
    """(a * b) >> 15, saturated."""
    return sature((_c(a) * _c(b)) >> 15)


def mult_r(a, b):
    return sature((_c(a) * _c(b) + 0x4000) >> 15)


# ---- Word32 ops ----------------------------------------------------------

def L_sat(L):
    """Clamp an exact int64 value to the Word32 range."""
    return _clamp(_c(L), I32_MIN, I32_MAX)


def L_add(a, b):
    return L_sat(_c(a) + _c(b))


def L_sub(a, b):
    return L_sat(_c(a) - _c(b))


def L_mult(a, b):
    """2 * a * b; only -32768 * -32768 leaves int32 and saturates."""
    return L_sat(_c(a) * _c(b) * 2)


def L_mult0(a, b):
    return _c(a) * _c(b)


def L_mac(L, a, b):
    return L_add(L, L_mult(a, b))


def L_msu(L, a, b):
    return L_sub(L, L_mult(a, b))


def L_mac0(L, a, b):
    return L_sat(_c(L) + _c(a) * _c(b))


def L_msu0(L, a, b):
    return L_sat(_c(L) - _c(a) * _c(b))


def L_negate(L):
    return L_sat(-_c(L))


def L_abs(L):
    return L_sat(_t(L).abs())


def L_deposit_h(a):
    return _c(a) << 16


def L_deposit_l(a):
    return _c(a)


# ---- shifts (variable counts, negative counts shift the other way; a
# count given as an int takes the direct path) ---------------------------

def shr(a, n):
    """Word16 arithmetic >>; a negative count is shl."""
    a = _c(a)
    if isinstance(n, int):
        return _shl_pos(a, -n) if n < 0 else a >> min(n, 15)
    n = _c(n)
    r = _t(a) >> n.clamp(0, 15)          # >= 15 gives -1 or 0
    return torch.where(n < 0, _shl_pos(a, -n), r)


def shl(a, n):
    a = _c(a)
    if isinstance(n, int):
        return shr(a, -n) if n < 0 else _shl_pos(a, n)
    n = _c(n)
    return torch.where(n < 0, shr(a, (-n).clamp(min=0)), _shl_pos(a, n))


def _shl_pos(a, n):
    """shl for n >= 0: saturate when a * 2^n leaves the Word16 range (any
    nonzero a does for n > 15, so counts clamp at 16)."""
    if isinstance(n, int):
        return sature(a << min(n, 16))
    return sature(_t(a) << n.clamp(0, 16))


def L_shr(L, n):
    L = _c(L)
    if isinstance(n, int):
        return _L_shl_pos(L, -n) if n < 0 else L >> min(n, 31)
    n = _c(n)
    r = _t(L) >> n.clamp(0, 31)          # >= 31 gives -1 or 0
    return torch.where(n < 0, _L_shl_pos(L, -n), r)


def L_shl(L, n):
    L = _c(L)
    if isinstance(n, int):
        return L_shr(L, -n) if n <= 0 else _L_shl_pos(L, n)
    n = _c(n)
    return torch.where(n <= 0, L_shr(L, (-n).clamp(min=0)),
                       _L_shl_pos(L, n))


def _L_shl_pos(L, n):
    """L_shl for n >= 1: the loop saturates exactly when L * 2^n leaves
    int32 (any nonzero L does for n > 31, so counts clamp at 32)."""
    if isinstance(n, int):
        return L_sat(L << min(n, 32))
    return L_sat(_t(L) << n.clamp(0, 32))


def L_shr_r(L, n):
    L = _c(L)
    if isinstance(n, int):
        if n > 31:
            return L * 0
        return L_shr(L, n) + ((L >> (n - 1)) & 1 if n > 0 else 0)
    n = _c(n)
    bit = torch.where(n > 0, (_t(L) >> (n - 1).clamp(0, 31)) & 1, 0)
    return torch.where(n > 31, 0, L_shr(L, n) + bit)


def round_w(L):
    return extract_h(L_add(L, 0x8000))


# ---- norms ---------------------------------------------------------------

def _floor_log2(x):
    """floor(log2(x)) for 1 <= x < 2^32, by unrolled binary search."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        x = torch.where(big, x >> s, x)
        n = n + torch.where(big, s, 0)
    return n


def norm_s(a):
    a = _t(a)
    x = torch.where(a < 0, ~a, a)
    n = (14 - _floor_log2(x.clamp(min=1))).clamp(0, 15)
    n = torch.where(a == -1, 15, n)
    return torch.where(a == 0, 0, n)


def norm_l(L):
    L = _t(L)
    x = torch.where(L < 0, ~L, L)
    n = (30 - _floor_log2(x.clamp(min=1))).clamp(0, 31)
    n = torch.where(L == -1, 31, n)
    return torch.where(L == 0, 0, n)


def div_s(num, denom):
    """Fractional divide (0 <= num <= denom, denom > 0): 15 restoring
    division steps."""
    num, denom = _t(num), _t(denom)
    L_num = num
    out = torch.zeros_like(num)
    for _ in range(15):
        out = out * 2
        L_num = L_num * 2
        ge = L_num >= denom
        L_num = torch.where(ge, L_num - denom, L_num)
        out = out + ge.to(_i64)
    out = torch.where(num == denom, I16_MAX, out)
    return torch.where(num == 0, 0, out)


# ---- TETRA double-precision helpers (the composition of etsi_dsp.h) -----

def Load_sh(a, shift: int):
    return L_msu0(0, a, -(1 << shift))


def add_sh(L, a, shift: int):
    return L_msu0(L, a, -(1 << shift))


def sub_sh(L, a, shift: int):
    return L_mac0(L, a, -(1 << shift))


def Load_sh16(a):
    return L_msu(0, a, I16_MIN)


def add_sh16(L, a):
    return L_msu(L, a, I16_MIN)


def sub_sh16(L, a):
    return L_mac(L, a, I16_MIN)


_SHR0 = (16, 15, 14, 13, 12, 11, 10, 9)


def store_hi(L, shift: int):
    return extract_l(L_shr(L, _SHR0[shift]))


def L_comp(hi, lo):
    return add_sh(Load_sh(lo, 0), hi, 15)


def L_extract(L):
    hi = extract_h(L_shl(L, 1))
    lo = extract_l(sub_sh(L, hi, 15))
    return hi, lo


def mpy_32(hi1, lo1, hi2, lo2):
    p1 = extract_h(L_mult0(hi1, lo2))
    p2 = extract_h(L_mult0(lo1, hi2))
    L = L_mult0(hi1, hi2)
    L = add_sh(L, p1, 1)
    return add_sh(L, p2, 1)


def mpy_mix(hi1, lo1, lo2):
    p1 = extract_h(L_mult0(lo1, lo2))
    L = L_mult0(hi1, lo2)
    return add_sh(L, p1, 1)
