"""Location Information Protocol (ETSI TS 100 392-18-1) report parsing.

Behavioural equivalent of the reference's LIP decoding
(tetraear/core/protocol.py:1020-1088): short reports carry 24-bit latitude /
25-bit longitude, long reports 25/26 bits, both two's-complement scaled to
+-90 / +-180 degrees.
"""

from __future__ import annotations

import numpy as np

from tebench.frozen import burst as burst_mod


def parse_lip(data: bytes) -> str | None:
    """Decode a LIP payload into a human-readable position string."""
    if not data or len(data) < 2:
        return None
    try:
        # NMEA text first: '$' is 0x24 whose top bits are 00, so in the
        # reference the binary short-report branch shadows the NMEA check
        # entirely (protocol.py:1040-1083 — dead code); test printable ASCII
        # before interpreting bits.
        if all(32 <= b <= 126 or b in (10, 13) for b in data[:16]):
            try:
                text = data.decode("ascii")
                if "$GPGGA" in text or "$GPRMC" in text:
                    return f"NMEA: {text.strip()}"
            except UnicodeDecodeError:
                pass

        bits = burst_mod.bytes_to_bits(data)
        pdu_type = burst_mod.bits_to_uint(bits[0:2])

        if pdu_type == 0:  # Short location report
            if len(bits) < 65:
                return None
            lat_raw = burst_mod.bits_to_int_signed(bits[4:28])
            lat = lat_raw * 90.0 / (1 << 23)
            lon_raw = burst_mod.bits_to_int_signed(bits[28:53])
            lon = lon_raw * 180.0 / (1 << 24)
            return f"Lat: {lat:.5f}, Lon: {lon:.5f} (Short)"

        if pdu_type == 1:  # Long location report
            if len(bits) < 75:
                return None
            lat_raw = burst_mod.bits_to_int_signed(bits[4:29])
            lat = lat_raw * 90.0 / (1 << 24)
            lon_raw = burst_mod.bits_to_int_signed(bits[29:55])
            lon = lon_raw * 180.0 / (1 << 25)
            return f"Lat: {lat:.5f}, Lon: {lon:.5f} (Long)"

    except Exception:
        return None
    return None


def encode_lip_short(lat: float, lon: float) -> bytes:
    """Inverse of the short-report parser; used to build golden fixtures.

    The trailing position-error/velocity/direction fields are set nonzero so
    the payload survives the SDS layer's trailing-NUL strip
    (tetraear/core/protocol.py:876) — an all-zero tail would be truncated
    below the 65-bit minimum before the parser ever sees it.
    """
    lat_raw = int(round(lat * (1 << 23) / 90.0))
    lon_raw = int(round(lon * (1 << 24) / 180.0))
    bits = np.zeros(72, dtype=np.uint8)
    # type=00, time-elapsed=00 already zero
    for i, b in enumerate(f"{lat_raw & ((1 << 24) - 1):024b}"):
        bits[4 + i] = int(b)
    for i, b in enumerate(f"{lon_raw & ((1 << 25) - 1):025b}"):
        bits[28 + i] = int(b)
    bits[53:56] = 1          # position error = 7 (unknown)
    bits[56:61] = 1          # horizontal velocity field nonzero
    bits[64:72] = 1          # keep the final octet nonzero
    return burst_mod.bits_to_bytes(bits)
