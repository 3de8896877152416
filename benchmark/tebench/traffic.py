"""A cell's traffic: which carriers send what, drawn from the seed.

A traffic mix (``traffic/<name>.json``) gives the share of the band's
channels that carry a downlink and how those split into clear SDS text,
TEA-encrypted text under a common key or an unknown one, and voice
calls (a share of them stealing slots).  ``make`` draws the carriers,
their contents, their slot timing and their symbol delay from the seed,
builds every carrier's periodic bit stream, and records what each
carrier sends (the ``Truth``) for the comparison after the window.
Every seed gets the same number of carriers of each kind.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from tebench import keyplan, slots, speechcode
from tebench.slots import SLOT_SYMS

ROLES = ("sds", "tea_common", "tea_unknown", "voice")
ENC_MODE = {"TEA1": 1, "TEA2": 2}
MIN_LEAD = 32          # symbols before a carrier's first slot
CLOSE = 2              # symbols rewritten to close the phase
MAX_AGREE = 18         # most sync bits a window across the gap may match
SYNC_LAG = slots.SYNC_AT   # bits from a frame's start to its sync word


@dataclass
class Carrier:
    index: int
    role: str
    lead: int                                  # first slot's symbol
    delay: float                               # samples
    text: str | None = None
    payload: bytes | None = None               # MAC payload as sent
    family: str | None = None
    key: bytes | None = None
    plaintext: bytes | None = None
    params: np.ndarray | None = None           # (n_slots, 2, 138) int16
    stolen: np.ndarray | None = None           # (n_slots,) bool
    crc_ok: np.ndarray | None = None           # (n_slots,) data slots


@dataclass
class Truth:
    n_carriers: int
    block_syms: int
    cycle_blocks: int
    n_slots: int                               # slots a carrier a cycle
    carriers: dict = field(default_factory=dict)   # index -> Carrier

    @property
    def cycle_syms(self) -> int:
        return self.block_syms * self.cycle_blocks


def counts(mix: dict, n_active: int) -> dict:
    """Carriers of each role: the mix's shares of n_active, rounded by
    largest remainder so that they add up to n_active."""
    shares = {r: float(mix.get(r, 0.0)) for r in ROLES}
    total = sum(shares.values())
    raw = {r: n_active * s / total for r, s in shares.items()}
    out = {r: int(math.floor(v)) for r, v in raw.items()}
    left = n_active - sum(out.values())
    for r in sorted(ROLES, key=lambda r: -(raw[r] - out[r]))[:left]:
        out[r] += 1
    return out


def _number(rng, used: set) -> int:
    while True:
        n = int(rng.integers(0, 10000))
        if n not in used:
            used.add(n)
            return n


def _secret(num: int) -> bytes:
    msg = b"\x82" + f"SECRET {num:04d}".encode()
    return msg + b"\x00" * (-len(msg) % 8)


def make(n_carriers: int, block_syms: int, traffic: dict, seed: int,
         sps: float) -> tuple:
    """(bits (n_active, 2 * cycle_syms) uint8, active carrier indices,
    Truth) for one seed."""
    rng = np.random.default_rng(seed)
    cycle_blocks = int(traffic["cycle_blocks"])
    ns = block_syms * cycle_blocks
    n_slots = (ns - MIN_LEAD - CLOSE) // SLOT_SYMS
    slack = ns - n_slots * SLOT_SYMS
    n_active = int(round(float(traffic["active_share"]) * n_carriers))
    per_role = counts(traffic["mix"], n_active)
    active = np.sort(rng.choice(n_carriers, n_active, replace=False))
    roles = np.repeat(np.array(ROLES), [per_role[r] for r in ROLES])
    rng.shuffle(roles)
    stealing_share = float(traffic.get("voice_stealing_share", 0.0))
    stolen_every = int(traffic.get("stolen_every", 4))
    truth = Truth(n_carriers, block_syms, cycle_blocks, n_slots)
    bits = np.zeros((n_active, 2 * ns), np.uint8)
    used: set = set()
    fams = {"tea_common": 0, "tea_unknown": 0}
    n_voice = 0
    keys = keyplan.common_keys()
    for row, (ci, role) in enumerate(zip(active.tolist(), roles.tolist())):
        steals = (role == "voice" and n_voice
                  < round(stealing_share * per_role["voice"]))
        n_voice += role == "voice"
        fam = None
        if role in fams:
            fam = ("TEA1", "TEA2")[fams[role] % 2]
            fams[role] += 1
        while True:
            car, stream = _carrier(ci, role, fam, steals, stolen_every, ns,
                                   n_slots, slack, sps, rng, used, keys)
            if _clean_gap(stream, car.lead, n_slots, rng):
                break
        bits[row] = stream
        truth.carriers[ci] = car
    return bits, active, truth


def _carrier(ci, role, fam, steals, stolen_every, ns, n_slots, slack, sps,
             rng, used, keys) -> tuple:
    """(Carrier, its bit stream over one cycle) for one draw."""
    lead = int(rng.integers(MIN_LEAD, slack - CLOSE + 1))
    car = Carrier(ci, role, lead, float(rng.uniform(0.0, sps)))
    stream = rng.integers(0, 2, 2 * ns).astype(np.uint8)
    if role == "sds":
        car.text = f"FLEET {_number(rng, used):04d}"
        car.payload = b"\x82" + car.text.encode("latin-1")
        view = slots.data_view(slots.mac_resource_fixed(car.payload), rng)
        body = slots.data_slots(view, n_slots, rng)
        car.crc_ok = slots.crc_verdicts(body)
    elif fam is not None:
        car.family = fam
        for _ in range(200):
            car.plaintext = _secret(_number(rng, used))
            if role == "tea_common":
                pool = keys[car.family]
                car.key = pool[int(rng.integers(0, len(pool)))]
            else:
                car.key = rng.integers(0, 256, 10 if fam == "TEA1" else 16,
                                       dtype=np.uint8).tobytes()
            car.payload = keyplan.encrypt(car.plaintext, car.key, fam)
            got = keyplan.decision(car.payload, fam)
            if role == "tea_unknown" or got["plaintext"] == car.plaintext:
                break
        else:
            raise RuntimeError("no common key decrypts a draw")
        view = slots.data_view(slots.mac_resource_fixed(
            car.payload, enc_mode=ENC_MODE[fam]), rng)
        body = slots.data_slots(view, n_slots, rng)
        car.crc_ok = slots.crc_verdicts(body)
    else:
        frames = rng.integers(0, 2, (n_slots, 2, 137)).astype(np.uint8)
        fa, fb = frames[:, 0], frames[:, 1]
        speechcode.force_header(fa, fb)
        car.stolen = np.zeros(n_slots, bool)
        if steals:
            car.stolen[stolen_every - 1::stolen_every] = True
        body = np.zeros((n_slots, slots.SLOT_BITS), np.uint8)
        body[~car.stolen] = slots.voice_slots(
            speechcode.encode_slots(fa[~car.stolen], fb[~car.stolen]), rng)
        if car.stolen.any():
            body[car.stolen] = slots.stolen_slots(
                speechcode.encode_stolen(fb[car.stolen]), rng)
        car.params = np.zeros((n_slots, 2, 138), np.int16)
        car.params[:, :, 1:] = frames
        car.params[car.stolen, 0, :] = 0
        car.params[car.stolen, 0, 0] = 1
    stream[2 * lead:2 * lead + 2 * n_slots * SLOT_SYMS] = body.reshape(-1)
    return car, stream


def _sync_agreement(stream: np.ndarray, lo: int, hi: int) -> int:
    """Most bits any 22-bit window starting in [lo, hi) (circular) shares
    with either downlink sync word."""
    n = len(stream)
    idx = (np.arange(lo, hi)[:, None] + np.arange(22)[None, :]) % n
    win = stream[idx]
    return int(max((win == w).sum(axis=1).max()
                   for w in (slots.SYNC_C, slots.SYNC_D)))


def _clean_gap(stream: np.ndarray, lead: int, n_slots: int,
               rng: np.random.Generator) -> bool:
    """Redraw, in place, the filler between a carrier's last slot of a
    cycle and its first slot of the next (the only stretch of a stream
    that is not a slot) so that no frame could start inside it, then
    close the phase.  A downlink sends slots back to back; a gap is the
    cycle's, and a sync word found with its frame starting there would
    hide the slot after it, which no real downlink does.  A frame starts
    216 bits before its sync word, so the windows checked run into the
    next slot's first 216 bits; False where that slot itself holds a
    near-sync window (the caller draws the carrier again)."""
    from tebench import synth
    n = len(stream)
    g0 = 2 * (lead + n_slots * SLOT_SYMS)          # gap start (bits)
    g1 = n + 2 * lead                               # gap end, circular
    lo, hi = g0 + SYNC_LAG, g1 + SYNC_LAG
    if _sync_agreement(stream, max(lo, g1), hi) > MAX_AGREE:
        return False
    for _ in range(1000):
        fill = rng.integers(0, 2, g1 - g0).astype(np.uint8)
        stream[np.arange(g0, g1) % n] = fill
        synth.close_phase(stream[None, :])
        if _sync_agreement(stream, lo, hi) <= MAX_AGREE:
            return True
    return False
