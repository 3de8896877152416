"""Batched ETSI ACELP speech decoder (tetraear_tpu/voice/jspeech.py).

A bank of decoder slots, each one carrier's speech decoder state, turns
[BFI + 137 serial bits] frames into 8 kHz PCM, bit-exact against the
C++ decoder (voice/csrc/etsi_acelp_dec.cpp, itself pinned to the ETSI
reference binary), concealment state included.

  * ``SpeechState``: the JAX package's eight fields in its order, batch
    major int32 (Word16 values), so checkpoint leaves line up;
  * ``decode_block(state, frames, valid, rows=None)``: the kernel
    wrapper.  On CUDA tensors it launches the hand-written
    ``acelp_decode`` kernel (dsp/csrc/speech.cu + speech.cuh, a CTA of
    two warps a decoder slot, built with the other kernels by
    dsp.cuda_kernels, one count in ``cuda_kernels.launches
    ["acelp_decode"]`` a launch); on CPU tensors it runs
    ``decode_block_plain``;
  * ``decode_block_plain``: the plain version, a straight port of
    jspeech.py's decoder onto voice/fixed.py's basicops, with the
    sample recursions (long-term predictor, synthesis filters, pitch
    sharpening, energy sums) as Python loops over samples and the slots
    in the batch.

Layout (as jspeech.py and the C++ decoder): the excitation buffer keeps
the C layout, 159 history words + 240 frame + 60 scratch, shifted by
EXC_OFF words a frame; the one-word over-allocation for the t0 = 143,
frac = +1 corner is reproduced.  Every 137-bit pattern maps to in-range
codebook indices, so gathers need no clamping.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.voice import acelp_tables as T
from tetraear_tpu_torch.voice import fixed as F

L_FRAME = 240
L_SUBFR = 60
EXC_OFF = 143 + 16            # etsi_acelp_dec.cpp EXC_OFF
EXC_LEN = EXC_OFF + L_FRAME + L_SUBFR
N_BITS = 138                  # BFI + 137 serial bits


def _fac_pond(gamma: int) -> list:
    """Fac_Pond: the LPC weighting factors (exact host ints)."""
    fac = [gamma]
    for _ in range(9):
        p = fac[-1] * gamma * 2               # L_mult (no sat possible)
        fac.append((p + 0x8000) >> 16)        # round_w
    return fac


F_GAMMA3 = _fac_pond(0x6000)
F_GAMMA4 = _fac_pond(0x6CCD)


class SpeechState(NamedTuple):
    """Per-slot decoder state, batch-major int32 (Word16 values)."""
    old_exc: torch.Tensor        # (S, EXC_LEN)
    lspold: torch.Tensor         # (S, 10)
    lspnew: torch.Tensor         # (S, 10): scratch that persists (C)
    mem_syn: torch.Tensor        # (S, 10)
    old_parm: torch.Tensor       # (S, 23)
    old_t0: torch.Tensor         # (S,)
    last_ener_pit: torch.Tensor  # (S,)
    last_ener_cod: torch.Tensor  # (S,)


def init_state(slots: int, device=None) -> SpeechState:
    """``slots`` fresh decoders on ``device`` (None: the card)."""
    z = dict(dtype=torch.int32, device=resolve(device))
    lsp = torch.as_tensor(T.LSPOLD_INIT, **z)
    return SpeechState(
        old_exc=torch.zeros((slots, EXC_LEN), **z),
        lspold=lsp[None].repeat(slots, 1),
        lspnew=torch.zeros((slots, 10), **z),
        mem_syn=torch.zeros((slots, 10), **z),
        old_parm=torch.zeros((slots, 23), **z),
        old_t0=torch.full((slots,), 60, **z),
        last_ener_pit=torch.zeros((slots,), **z),
        last_ener_cod=torch.zeros((slots,), **z))


def reset_rows(state: SpeechState, mask: torch.Tensor) -> SpeechState:
    """Reset the masked rows to the fresh-decoder state (slot reuse in
    speech_pool.DeviceSpeechPool).  mask: (S,) bool."""
    init = init_state(mask.shape[0], mask.device)
    return SpeechState(*(
        torch.where(mask.reshape(mask.shape + (1,) * (s.dim() - 1)), i, s)
        for i, s in zip(init, state)))


# ---- tables ----------------------------------------------------------------

_TAB_CACHE: dict = {}


def _tab(name: str, dev) -> torch.Tensor:
    key = (name, str(dev))
    if key not in _TAB_CACHE:
        _TAB_CACHE[key] = torch.as_tensor(
            np.asarray(getattr(T, name), np.int64), device=dev)
    return _TAB_CACHE[key]


# bit weights and parameter spans of Bits2prm: parameter j is the
# MSB-first integer of serial bits [_P_START[j], _P_END[j])
_P_END = np.cumsum(T.BITNO)
_P_START = _P_END - T.BITNO
_BIT_W = np.concatenate([1 << np.arange(nb - 1, -1, -1) for nb in T.BITNO])


def bits2prm(frames: torch.Tensor) -> torch.Tensor:
    """(..., 138) [BFI + 137 serial bits] -> (..., 24) int64 parameters
    [BFI, p1..p23] (only the low bit of each serial word counts)."""
    dev = frames.device
    bits = (frames[..., 1:] & 1).to(torch.int64)
    cs = torch.cumsum(bits * torch.as_tensor(_BIT_W, device=dev), dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    prm = (cs[..., torch.as_tensor(_P_END, device=dev)]
           - cs[..., torch.as_tensor(_P_START, device=dev)])
    return torch.cat([frames[..., :1].to(torch.int64), prm], dim=-1)


def prm2bits(prm: np.ndarray) -> np.ndarray:
    """(..., 24) [BFI, 23 parameters] -> (..., 138) int32 serial frames,
    MSB first (the inverse of ``bits2prm``; tetra_etsi_prm2bits)."""
    prm = np.asarray(prm, np.int64)
    out = np.zeros(prm.shape[:-1] + (N_BITS,), np.int32)
    out[..., 0] = prm[..., 0]
    shift = np.concatenate([np.arange(nb - 1, -1, -1) for nb in T.BITNO])
    owner = np.repeat(np.arange(23), T.BITNO)
    out[..., 1:] = (prm[..., 1 + owner] >> shift) & 1
    return out


# ---- transcendentals --------------------------------------------------------

def _log2(L_x):
    """Log2_: (B,) Word32 -> (exponent, fraction) (B,) Word16."""
    e = F.norm_l(L_x)
    Lx = F.L_shl(L_x, e)
    exponent = F.sub(30, e)
    Lx = F.L_shr(Lx, 9)
    i = F.extract_h(Lx)
    Lx = F.L_shr(Lx, 1)
    a = F.extract_l(Lx) & 0x7FFF
    i = F.sub(i, 32)
    ii = i.clamp(0, 31)                        # in range unless L_x <= 0
    tab = _tab("TAB_LOG2", L_x.device)
    ti = tab[ii]
    ti1 = tab[ii + 1]
    L_y = F.L_deposit_h(ti)
    L_y = F.L_msu(L_y, F.sub(ti, ti1), a)
    frac = F.extract_h(L_y)
    bad = L_x <= 0
    return torch.where(bad, 0, exponent), torch.where(bad, 0, frac)


def _pow2(exponent, fraction):
    """Pow2_: (B,) Word16 pair -> (B,) Word32."""
    Lx = F.L_shl(F.L_deposit_l(fraction), 6)
    i = F.extract_h(Lx)
    Lx = F.L_shr(Lx, 1)
    a = F.extract_l(Lx) & 0x7FFF
    ii = i.clamp(0, 31)
    tab = _tab("TAB_POW2", fraction.device)
    ti = tab[ii]
    ti1 = tab[ii + 1]
    L = F.L_deposit_h(ti)
    L = F.L_msu(L, F.sub(ti, ti1), a)
    return F.L_shr_r(L, F.sub(30, exponent))


# ---- LSP -------------------------------------------------------------------

def _d_lsp334(idx, old_lsp: list) -> list:
    """D_Lsp334: idx (B, 3) codebook indices -> lsp, 10 columns (B,)."""
    dev = idx.device
    l1 = _tab("DICO1_CLSP", dev)[idx[:, 0]]
    l2 = _tab("DICO2_CLSP", dev)[idx[:, 1]]
    l3 = _tab("DICO3_CLSP", dev)[idx[:, 2]]
    lsp = torch.cat([l1, l2, l3], dim=1).unbind(1)
    lsp = list(lsp)
    for lo, hi, gap in ((2, 3, 917), (5, 6, 1245)):
        tmp = F.add(F.sub(gap, lsp[lo]), lsp[hi])
        hit = tmp > 0
        t2 = F.shr(tmp, 1)
        lsp[lo], lsp[hi] = (torch.where(hit, F.add(lsp[lo], t2), lsp[lo]),
                            torch.where(hit, F.sub(lsp[hi], t2), lsp[hi]))
    bad = F.sub(lsp[0], lsp[1]) <= 0
    for i in range(1, 9):
        bad = bad | (F.sub(lsp[i], lsp[i + 1]) <= 0)
    return [torch.where(bad, o, n) for o, n in zip(old_lsp, lsp)]


def _get_lsp_pol(lsp5: list) -> list:
    """Get_Lsp_Pol on one cosine-LSP half: 5 (B,) Word16 columns -> 6
    (B,) Word32.  Replays the reference's in-place pointer walk (the
    inner loop revisits lower coefficients)."""
    f = [None] * 6
    f[0] = torch.full_like(lsp5[0], F.Load_sh(4096, 12))
    f[1] = F.sub_sh(0, lsp5[0], 10)
    p = 2
    li = 1
    for i in range(2, 6):
        f[p] = f[p - 2]
        for _j in range(1, i):
            hi, lo = F.L_extract(f[p - 1])
            t0 = F.L_shl(F.mpy_mix(hi, lo, lsp5[li]), 1)
            f[p] = F.L_add(f[p], f[p - 2])
            f[p] = F.L_sub(f[p], t0)
            p -= 1
        f[p] = F.sub_sh(f[p], lsp5[li], 10)
        p += i
        li += 1
    return f


def _lsp_az(lsp: list) -> list:
    """Lsp_Az: 10 cosine-LSP columns -> 11 LPC coefficient columns."""
    f1 = _get_lsp_pol(lsp[0::2])
    f2 = _get_lsp_pol(lsp[1::2])
    for i in range(5, 0, -1):
        f1[i] = F.L_add(f1[i], f1[i - 1])
        f2[i] = F.L_sub(f2[i], f2[i - 1])
    a = [torch.full_like(lsp[0], 4096)] + [None] * 10
    for i in range(1, 6):
        a[i] = F.extract_l(F.L_shr_r(F.L_add(f1[i], f2[i]), 13))
        a[11 - i] = F.extract_l(F.L_shr_r(F.L_sub(f1[i], f2[i]), 13))
    return a


def _int_lpc4(lsp_old: list, lsp_new: list) -> list:
    """Int_Lpc4: the four subframes' interpolated LPC sets (11 columns
    each)."""
    sets = []
    fac_new, fac_old = 0x2000, 0x6000
    for _ in range(3):
        lsp = [F.extract_h(F.L_mac(F.L_mult(o, fac_old), n, fac_new))
               for o, n in zip(lsp_old, lsp_new)]
        sets.append(_lsp_az(lsp))
        fac_old -= 0x2000
        fac_new += 0x2000
    sets.append(_lsp_az(lsp_new))
    return sets


def _pond_ai(a: list, fac: list) -> list:
    """Pond_Ai with a constant factor table."""
    return [a[0]] + [F.round_w(F.L_mult(a[i], fac[i - 1]))
                     for i in range(1, 11)]


# ---- filters ---------------------------------------------------------------

def _syn_filt_step(a: list, m: list, xi):
    """One Syn_Filt sample: memory m (10 columns, m[9] the most recent
    output), input xi (B,) -> (new m, y)."""
    L = F.Load_sh(xi, 12)
    for j in range(1, 11):
        L = F.L_msu0(L, a[j], m[10 - j])
    L = F.add_sh(L, 1, 11)
    L = F.L_shl(L, 4)
    y = F.extract_h(L)
    return m[1:] + [y], y


def _syn_filt(a: list, x: list, mem: list) -> tuple:
    """Syn_Filt over the input columns x; returns (y columns, new mem)."""
    ys = []
    for xi in x:
        mem, y = _syn_filt_step(a, mem, xi)
        ys.append(y)
    return ys, mem


def _lpc_gain(a: list):
    """Lpc_Gain: (B,) Word32 energy of the filter's impulse response."""
    zero = torch.zeros_like(a[0])
    m = [zero] * 10
    L = zero
    for i in range(L_SUBFR):
        m, y = _syn_filt_step(a, m, 0x400 if i == 0 else zero)
        L = F.L_mac0(L, y, y)
    return L


def _mac0_chain(init, x, y):
    """Sequential saturating sum(x * y) over the last axis (each partial
    sum saturates on its own, so the order counts)."""
    prod = x * y
    L = init
    for i in range(prod.shape[1]):
        L = F.L_sat(L + prod[:, i])
    return L


# ---- adaptive codebook -----------------------------------------------------

def _pred_lt(buf, t0, frac, base: int):
    """Pred_Lt on the excitation buffer (B, EXC_LEN) at offset ``base``.
    A new sample feeds later taps (its position i + t0 + 16 of the
    window is read again), so the 60 samples run in order: the window
    of every step (92 words from base - t0 - 16) is gathered once, each
    sample is written back into it, and position 92 takes the samples
    that are never read again.  With t0 = 144 (delta index 31 in
    subframes 2-4, or a BFI frame after one) the window starts one word
    before the buffer; only frac = +1 reads that word, and t0 = 144
    always has frac = -1 (or 0), so the gather clamps it."""
    dev = buf.device
    b = buf.shape[0]
    w_ext = L_SUBFR + 32
    j = torch.arange(w_ext, device=dev)
    ext = buf.gather(1, ((base - t0 - 16)[:, None] + j[None]).clamp(min=0))
    ext = torch.cat([ext, torch.zeros_like(ext[:, :1])], dim=1)
    wrap = t0 + 16
    m1 = (frac == -1)[:, None]
    coef = torch.where(m1, _tab("COEF2", dev)[None], _tab("COEF1", dev)[None])
    rows = torch.arange(b, device=dev)
    vals = []
    for i in range(L_SUBFR):
        w = ext[:, i:i + 33]
        # Inter32_1_3 reads x[k - 16] with COEF1, Inter32_M1_3 x[k - 15]
        # with COEF2 (k = 0..31)
        prod = torch.where(m1, w[:, 1:33], w[:, 0:32]) * coef
        L = prod[:, 0]
        for k in range(1, 32):
            L = F.L_sat(L + prod[:, k])
        v = F.round_w(F.L_add(L, L))
        val = torch.where(frac == 0, w[:, 16], v)
        ext[rows, (i + wrap).clamp(max=w_ext)] = val
        vals.append(val)
    buf[:, base:base + L_SUBFR] = torch.stack(vals, dim=1)
    return buf


def _sharpen(h, t0):
    """Pitch-sharpen the impulse response in place: h (B, 60),
    h[i] += mult(h[i - t0], 0x6668) for i >= t0 (recursive when
    2 * t0 <= 59)."""
    for i in range(L_SUBFR):
        src = i - t0
        hv = h.gather(1, src.clamp(min=0)[:, None])[:, 0]
        cur = h[:, i]
        h[:, i] = torch.where(src >= 0, F.add(cur, F.mult(hv, 0x6668)), cur)
    return h


def _d_d4i60(index, sign, shift, h):
    """D_D4i60: algebraic-codebook vector from the weighted impulse
    response h (B, 60) -> cod (B, 60)."""
    p0 = (index & 0x1F) * 2
    p1 = ((index & 0xE0) >> 2) + 2
    p2 = ((index & 0x700) >> 5) + 4
    p3 = ((index & 0x3800) >> 8) + 6
    fbuf = torch.cat([torch.zeros_like(h[:, :1]).expand(-1, 64), h], dim=1)
    ar = torch.arange(L_SUBFR, device=h.device)

    def tap(p):
        return fbuf.gather(1, (64 - shift - p)[:, None] + ar)

    L = F.L_mult0(tap(p0), 0x0B50)
    L = F.sub_sh(L, tap(p1), 11)
    L = F.add_sh(L, tap(p2), 11)
    L = F.sub_sh(L, tap(p3), 11)
    L = torch.where((sign != 0)[:, None], F.L_negate(L), L)
    return F.store_hi(L, 5)


# ---- gains ------------------------------------------------------------------

def _ener_measure(a: list, prd_lt, code):
    """Ener_Measure: -> (ener_pit, ener_cod) (B,) Word16."""
    Lg = _lpc_gain(a)
    exp_lpc = F.norm_l(Lg)
    g_lpc = F.extract_h(F.L_shl(Lg, exp_lpc))

    L = _mac0_chain(torch.ones_like(Lg), prd_lt, prd_lt)
    exp_plt = F.norm_l(L)
    t16 = F.extract_h(F.L_shl(L, exp_plt))
    L = F.L_mult0(t16, g_lpc)
    exp_plt = F.add(exp_plt, exp_lpc)
    e16, frac = _log2(L)
    L = F.Load_sh16(e16)
    L = F.add_sh(L, frac, 1)
    L = F.sub_sh16(L, exp_plt)
    L = F.add_sh(L, 0x6AE, 8)
    ener_pit = F.extract_l(F.L_shr(L, 8))

    L = _mac0_chain(torch.zeros_like(Lg), code, code)
    t16 = F.extract_h(L)
    L = F.L_mult0(t16, g_lpc)
    e16, frac = _log2(L)
    L = F.Load_sh16(e16)
    L = F.add_sh(L, frac, 1)
    L = F.sub_sh16(L, exp_lpc)
    L = F.sub_sh(L, 0x1152, 8)
    ener_cod = F.extract_l(F.L_shr(L, 8))
    return ener_pit, ener_cod


def _ener_update(index, last_pit, last_cod):
    L = F.Load_sh(last_pit, 8)
    L = F.add_sh(L, last_cod, 7)
    L = F.sub_sh(L, 0x300, 9)
    pred_pit = F.store_hi(L.clamp(min=0), 7)
    L = F.Load_sh(last_cod, 8)
    L = F.add_sh(L, last_pit, 7)
    L = F.sub_sh(L, 0x300, 9)
    pred_cod = F.store_hi(L.clamp(min=0), 7)
    q = _tab("T_QUA_ENER", index.device)[index]              # (B, 2)
    new_pit = F.add(q[:, 0], pred_pit)
    new_cod = F.add(q[:, 1], pred_cod)
    new_pit = torch.where(F.sub(new_pit, 0x1B00) > 0, 0x1B00, new_pit)
    new_cod = torch.where(F.sub(new_cod, 0x1900) > 0, 0x1900, new_cod)
    return new_pit, new_cod


def _ener_gains(last_pit, last_cod, ener_pit, ener_cod):
    L = F.Load_sh(last_pit, 6)
    L = F.sub_sh(L, ener_pit, 6)
    L = F.add_sh(L, 12, 15)
    e16, frac = F.L_extract(L)
    L = _pow2(e16, frac)
    gain_pit = F.extract_l(torch.where(F.L_sub(L, 0x1333) > 0, 0x1333, L))
    L = F.Load_sh(last_cod, 6)
    L = F.sub_sh(L, ener_cod, 6)
    e16, frac = F.L_extract(L)
    gain_cod = F.extract_l(_pow2(e16, frac))
    return gain_pit, gain_cod


# ---- frame decode -----------------------------------------------------------

def decode_frame_plain(state: SpeechState, prm) -> tuple:
    """One 30 ms frame for every slot.  state: int64 leaves; prm (B, 24)
    int64 [BFI, 23 parameters]; returns (new state, (B, 240) synth),
    synth before Post_Process (as tetra_etsi_decode_frame)."""
    isbfi = prm[:, 0] != 0
    isbfi_c = isbfi[:, None]
    parm = prm[:, 1:]

    lsp_dec = torch.stack(_d_lsp334(parm[:, :3], state.lspold.unbind(1)), 1)
    lsp_conceal = torch.cat([state.lspnew[:, :1], state.lspold[:, 1:]], 1)
    lspnew = torch.where(isbfi_c, lsp_conceal, lsp_dec)
    # the consumed parameter stream doubles as the next frame's
    # concealment source (C: parm = old_parm when BFI)
    p = torch.where(isbfi_c, state.old_parm, parm)

    a_t = _int_lpc4(state.lspold.unbind(1), lspnew.unbind(1))

    buf = state.old_exc.clone()
    mem_syn = list(state.mem_syn.unbind(1))
    t0 = state.old_t0
    frac = torch.zeros_like(t0)
    t0_min = torch.zeros_like(t0)
    last_pit = state.last_ener_pit
    last_cod = state.last_ener_cod
    zero10 = [torch.zeros_like(t0)] * 10
    parts = []

    for s in range(4):
        a = a_t[s]
        index = p[:, 3 + 5 * s]
        if s == 0:
            le196 = F.sub(index, 196) <= 0
            tmp = F.mult(F.add(index, 2), 0x2AAB)
            t0_a = F.add(tmp, 19)
            tmp2 = F.sub(58, F.add(F.add(t0_a, t0_a), t0_a))
            frac_a = F.add(index, tmp2)
            t0_new = torch.where(le196, t0_a, F.sub(index, 112))
            frac_new = torch.where(le196, frac_a, 0)
            t0 = torch.where(isbfi, state.old_t0, t0_new)
            frac = torch.where(isbfi, 0, frac_new)
            t0_min = F.sub(t0, 5)
            t0_min = torch.where(F.sub(t0_min, 19) <= 0, 20, t0_min)
            t0_max = F.add(t0_min, 9)
            over = F.sub(t0_max, 143) > 0
            t0_max = torch.where(over, 143, t0_max)
            t0_min = torch.where(over, F.sub(t0_max, 9), t0_min)
        else:
            tmp = F.sub(F.mult(F.add(index, 2), 0x2AAB), 1)
            t0_new = F.add(t0_min, tmp)
            tmp2 = F.add(F.add(F.add(tmp, tmp), tmp), 2)
            frac_new = F.sub(index, tmp2)
            t0 = torch.where(isbfi, t0, t0_new)
            frac = torch.where(isbfi, frac, frac_new)

        base = EXC_OFF + L_SUBFR * s
        buf = _pred_lt(buf, t0, frac, base)
        prd_lt = buf[:, base:base + L_SUBFR].clone()

        ap3 = _pond_ai(a, F_GAMMA3)
        ap4 = _pond_ai(a, F_GAMMA4)
        h0 = ap3 + [torch.zeros_like(t0)] * (L_SUBFR - 11)
        h, _ = _syn_filt(ap4, h0, zero10)
        h = _sharpen(torch.stack(h, dim=1), t0)

        code = _d_d4i60(p[:, 4 + 5 * s], p[:, 5 + 5 * s], p[:, 6 + 5 * s],
                        h)

        ener_pit, ener_cod = _ener_measure(a, prd_lt, code)
        up_pit, up_cod = _ener_update(p[:, 7 + 5 * s], last_pit, last_cod)
        dn_pit = F.sub(last_pit, 128).clamp(min=0)
        dn_cod = F.sub(last_cod, 128).clamp(min=0)
        last_pit = torch.where(isbfi, dn_pit, up_pit)
        last_cod = torch.where(isbfi, dn_cod, up_cod)
        gain_pit, gain_cod = _ener_gains(last_pit, last_cod, ener_pit,
                                         ener_cod)

        L = F.L_mult0(gain_pit[:, None], prd_lt)
        L = F.L_mac0(L, gain_cod[:, None], code)
        exc_new = F.extract_l(F.L_shr_r(L, 12))      # (Word16) cast
        buf[:, base:base + L_SUBFR] = exc_new

        y, mem_syn = _syn_filt(a, exc_new.unbind(1), mem_syn)
        parts.extend(y)

    synth = torch.stack(parts, dim=1)
    # the full EXC_OFF-word history shift: buf[EXC_OFF - 1] is this
    # frame's last excitation sample
    buf[:, :EXC_OFF] = buf[:, L_FRAME:L_FRAME + EXC_OFF].clone()
    new_state = SpeechState(
        old_exc=buf, lspold=lspnew, lspnew=lspnew,
        mem_syn=torch.stack(mem_syn, dim=1), old_parm=p, old_t0=t0,
        last_ener_pit=last_pit, last_ener_cod=last_cod)
    return new_state, synth


def decode_block_plain(state: SpeechState, frames, valid) -> tuple:
    """Plain version of ``decode_block`` over every row: F frames a slot
    in order; an invalid frame leaves its slot's state untouched and
    gives zeros.  Returns (new state, (B, F, 240) int32 PCM, Post_Process
    applied)."""
    st = SpeechState(*(x.to(torch.int64) for x in state))
    prm = bits2prm(frames)
    b, n_frames = valid.shape
    pcm = torch.zeros((b, n_frames, L_FRAME), dtype=torch.int32,
                      device=frames.device)
    for f in range(n_frames):
        v = valid[:, f]
        if not bool(v.any()):
            continue
        new, synth = decode_frame_plain(st, prm[:, f])
        st = SpeechState(*(
            torch.where(v.reshape(v.shape + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, st)))
        pcm[:, f] = torch.where(v[:, None], F.add(synth, synth), 0).to(
            torch.int32)
    return SpeechState(*(x.to(torch.int32) for x in st)), pcm


# ---- the kernel's tables ----------------------------------------------------

# One int16 table in the kernel's constant memory (c_tab in
# dsp/csrc/speech.cuh), the named tables one after the other; the
# offsets are the kernel's kOff* constants.
_K_PARTS = (("Dico1", T.DICO1_CLSP), ("Dico2", T.DICO2_CLSP),
            ("Dico3", T.DICO3_CLSP), ("QuaEner", T.T_QUA_ENER),
            ("Coef1", T.COEF1), ("Coef2", T.COEF2),
            ("Log2", T.TAB_LOG2), ("Pow2", T.TAB_POW2),
            ("LspoldInit", T.LSPOLD_INIT), ("Bitno", T.BITNO))
K_OFFSETS = {}
_off = 0
for _name, _arr in _K_PARTS:
    K_OFFSETS[_name] = _off
    _off += int(np.asarray(_arr).size)
_K_TAB = np.concatenate([np.asarray(a, np.int16).reshape(-1)
                         for _, a in _K_PARTS])


# ---- the wrapper ------------------------------------------------------------

def _check_state(state: SpeechState, slots: int) -> None:
    if not isinstance(state, SpeechState):
        raise TypeError(f"state: expected a SpeechState, got {type(state)}")
    shapes = [(slots, EXC_LEN), (slots, 10), (slots, 10), (slots, 10),
              (slots, 23), (slots,), (slots,), (slots,)]
    for name, leaf, shape in zip(SpeechState._fields, state, shapes):
        ck._check(leaf, name, shape, torch.int32)


def decode_block(state: SpeechState, frames: torch.Tensor,
                 valid: torch.Tensor, rows: torch.Tensor | None = None
                 ) -> tuple:
    """Decode up to F frames a slot, in order, for the slots ``rows``
    (A,) int32, a distinct slot list held on the host (a CPU tensor
    whatever the device, so that checking it costs no device sync; None:
    every slot, A = S).

    state:  SpeechState, int32 leaves (S, ...);
    frames: (A, F, 138) int32 [BFI + 137 serial bits] a frame;
    valid:  (A, F) bool: an invalid frame leaves the slot's state
            untouched and gives zeros, as if it never arrived.
    Returns (new state, (A, F, 240) int32 PCM, Post_Process applied).
    The given state is not changed.

    Replaces the reference's ``decode_block`` (jspeech.py:564, an XLA
    program of lax.scans).  Bound: latency, a slot's frames being one
    serial chain (~15,000 ETSI basic operations a frame, of which the
    synthesis filter's 240 samples and the excitation's pitch-gain
    chain are serial by nature).  Design: dsp/csrc/speech.cu, a CTA of
    two warps a slot with its state in shared memory: the
    parameter-only work of every subframe across lanes, then the
    excitation chain on one warp beside the synthesis filter, one
    subframe behind, on the other."""
    slots = state.old_t0.shape[0] if isinstance(state, SpeechState) else 0
    _check_state(state, slots)
    if rows is None:
        n_act = slots
    else:
        n_act = rows.shape[0] if rows.dim() == 1 else -1
        ck._check(rows, "rows", (n_act,), torch.int32)
    n_frames = frames.shape[1] if frames.dim() == 3 else -1
    ck._check(frames, "frames", (n_act, n_frames, N_BITS), torch.int32)
    ck._check(valid, "valid", (n_act, n_frames), torch.bool)
    if rows is not None:
        if rows.device.type != "cpu":
            raise ValueError(f"rows: the slot list is held on the host, "
                             f"got a tensor on {rows.device}")
        if n_act and (int(rows.min()) < 0 or int(rows.max()) >= slots
                      or rows.unique().numel() != n_act):
            raise ValueError(f"rows: {n_act} distinct slots in "
                             f"[0, {slots}) expected")
    if ck._route(*state, frames, valid) == "cpu":
        if rows is None:
            return decode_block_plain(state, frames, valid)
        idx = rows.long()
        sub, pcm = decode_block_plain(
            SpeechState(*(x[idx] for x in state)), frames, valid)
        new = SpeechState(*(x.clone() for x in state))
        for leaf, part in zip(new, sub):
            leaf[idx] = part
        return new, pcm
    dev = frames.device
    new = SpeechState(*(x.clone() for x in state))
    pcm = torch.empty((n_act, n_frames, L_FRAME), dtype=torch.int32,
                      device=dev)
    rows = (torch.arange(slots, dtype=torch.int32, device=dev)
            if rows is None else rows.to(dev))
    if n_act and n_frames:
        lib = ck.build()
        ck._launch("acelp_decode", dev, lib.tt_acelp,
                   ck._ptr(frames), ck._ptr(valid), ck._ptr(rows), n_act,
                   n_frames, *(ck._ptr(x) for x in new), ck._ptr(pcm),
                   _K_TAB.ctypes.data)
    else:
        pcm.zero_()
    return new, pcm
