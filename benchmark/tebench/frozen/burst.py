"""PHY burst layer: slot structure, burst typing, data-bit extraction.

Behavioural equivalent of the reference's PHY parsing
(tetraear/core/protocol.py:149-347): 255 symbols/slot, training sequence at
bits 108..121 of the slot's bit view, data bits = bits[0:108] ++ bits[122:230],
soft CRC-16 gate.  Data layout and enum values are kept identical so frame
dicts are field-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from tebench.frozen import crc as crc_mod

SYMBOLS_PER_SLOT = 255
SLOTS_PER_FRAME = 4
FRAMES_PER_MULTIFRAME = 18
MULTIFRAMES_PER_HYPERFRAME = 60

# 22-bit downlink sync trainings (ETSI EN 300 392-2; values as modelled by
# the reference, tetraear/core/protocol.py:162-163)
SYNC_CONTINUOUS_DOWNLINK = np.array(
    [1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0],
    dtype=np.uint8)
SYNC_DISCONTINUOUS_DOWNLINK = np.array(
    [0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0],
    dtype=np.uint8)

TRAINING_SEQUENCES = {
    1: np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1], dtype=np.uint8),
    2: np.array([0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1], dtype=np.uint8),
    3: np.array([0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0], dtype=np.uint8),
}


class BurstType(Enum):
    NormalUplink = 1
    NormalDownlink = 2
    ControlUplink = 3
    ControlDownlink = 4
    Synchronization = 5
    Linearization = 6


class ChannelType(Enum):
    TCH = "Traffic Channel"
    STCH = "Stealing Channel"
    SCH = "Signaling Channel"
    AACH = "Associated Control Channel"
    BSCH = "Broadcast Synchronization Channel"
    BNCH = "Broadcast Network Channel"


@dataclass
class TetraBurst:
    burst_type: BurstType
    slot_number: int
    frame_number: int
    training_sequence: np.ndarray
    data_bits: np.ndarray
    crc_ok: bool
    scrambling_code: int = 0
    colour_code: int = 0


def symbols_to_bits(symbols: np.ndarray) -> np.ndarray:
    """0-3 dibit symbols -> bits, MSB first (protocol.py:210-214)."""
    s = np.asarray(symbols, dtype=np.uint8)
    bits = np.empty(2 * len(s), dtype=np.uint8)
    bits[0::2] = (s >> 1) & 1
    bits[1::2] = s & 1
    return bits


def _pack_word(bits: np.ndarray) -> int:
    """<=64 bits (MSB first) -> int; no per-bit Python loop."""
    b = np.asarray(bits, dtype=np.uint8)
    return int.from_bytes(np.packbits(b).tobytes(), "big") >> (-len(b) % 8)


_SYNC_C_INT = _pack_word(SYNC_CONTINUOUS_DOWNLINK)
_SYNC_D_INT = _pack_word(SYNC_DISCONTINUOUS_DOWNLINK)


def sync_agreement(bits22: np.ndarray) -> tuple:
    """(matches vs TS1, matches vs TS2) of a 22-bit window via popcount
    — the host frame layer calls this per candidate, where two
    22-element np.mean dispatches were the measured hot spot."""
    w = _pack_word(bits22)
    return (22 - bin(w ^ _SYNC_C_INT).count("1"),
            22 - bin(w ^ _SYNC_D_INT).count("1"))


def check_sync_pattern(bits: np.ndarray) -> bool:
    """>80% agreement with either downlink sync word (protocol.py:256-265)."""
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 22:
        return False
    m1, m2 = sync_agreement(bits[:22])
    return max(m1, m2) > 0.8 * 22


def detect_burst_type(bits: np.ndarray) -> BurstType:
    """Sync burst iff a sync word sits at the slot midpoint; else normal DL
    (protocol.py:246-254)."""
    mid = len(bits) // 2
    if check_sync_pattern(bits[mid:mid + 22]):
        return BurstType.Synchronization
    return BurstType.NormalDownlink


def extract_training_sequence(bits: np.ndarray,
                              burst_type: BurstType) -> np.ndarray:
    if burst_type == BurstType.Synchronization:
        return np.asarray(bits[108:130], dtype=np.uint8)
    return np.asarray(bits[108:122], dtype=np.uint8)


def extract_data_bits(bits: np.ndarray, burst_type: BurstType) -> np.ndarray:
    """Normal burst payload: bits 0..107 ++ 122..229 (protocol.py:277-290)."""
    bits = np.asarray(bits, dtype=np.uint8)
    if burst_type in (BurstType.NormalDownlink, BurstType.NormalUplink):
        return np.concatenate([bits[0:108], bits[122:230]])
    return bits


def parse_burst_bits(bits: np.ndarray, slot_number: int = 0,
                     frame_number: int = 0, colour_code: int = 0,
                     stats: dict | None = None,
                     crc_hint: bool | None = None) -> TetraBurst | None:
    """parse_burst on an already-demapped bit view (2*SYMBOLS_PER_SLOT
    bits) — the frame layer holds bits, and converting back through
    symbols was a measured per-hit waste."""
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 2 * SYMBOLS_PER_SLOT:
        return None
    return _parse_burst_from_bits(bits[:2 * SYMBOLS_PER_SLOT],
                                  slot_number, frame_number, colour_code,
                                  stats, crc_hint)


def parse_burst(symbols: np.ndarray, slot_number: int = 0,
                frame_number: int = 0, colour_code: int = 0,
                stats: dict | None = None,
                crc_hint: bool | None = None) -> TetraBurst | None:
    """Parse one 255-symbol slot into a TetraBurst (protocol.py:192-244).

    ``crc_hint`` carries a CRC verdict precomputed on device for normal
    bursts (dsp.framescan dense CRC); a TRUE hint is trusted for the
    normal burst types whose data layout the device kernel models.  A
    FALSE hint only short-circuits nothing: the device scan checks the
    FORWARD orientation densely (the reversed-payload check would
    double its matmul cost fleet-wide), so the host completes the full
    forward+reversed verdict here — O(sync hits), identical final
    semantics to the reference's both-orientation check."""
    symbols = np.asarray(symbols)
    if len(symbols) < SYMBOLS_PER_SLOT:
        return None
    bits = symbols_to_bits(symbols[:SYMBOLS_PER_SLOT])
    return _parse_burst_from_bits(bits, slot_number, frame_number,
                                  colour_code, stats, crc_hint)


def _parse_burst_from_bits(bits, slot_number, frame_number, colour_code,
                           stats, crc_hint):
    btype = detect_burst_type(bits)
    training = extract_training_sequence(bits, btype)
    data_bits = extract_data_bits(bits, btype)
    if crc_hint and btype in (BurstType.NormalDownlink,
                              BurstType.NormalUplink):
        crc_ok = True
    else:
        crc_ok = crc_mod.soft_crc_check(data_bits)
    if stats is not None:
        stats["total_bursts"] += 1
        stats["crc_pass" if crc_ok else "crc_fail"] += 1
    return TetraBurst(
        burst_type=btype,
        slot_number=slot_number,
        frame_number=frame_number,
        training_sequence=training,
        data_bits=data_bits,
        crc_ok=crc_ok,
        colour_code=colour_code,
    )


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """Pack a bit vector (MSB first) into bytes, zero-padding the tail."""
    bits = np.asarray(bits, dtype=np.uint8)
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(bits).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), dtype=np.uint8))


def bits_to_uint(bits: np.ndarray) -> int:
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) == 0:
        return 0
    return _pack_word(bits)


def bits_to_int_signed(bits: np.ndarray) -> int:
    """Two's-complement interpretation, MSB first."""
    n = len(bits)
    v = bits_to_uint(bits)
    if n and (v >> (n - 1)) & 1:
        v -= 1 << n
    return v
