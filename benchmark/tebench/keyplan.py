"""What the receiver's auto-decrypt should make of an encrypted PDU.

A frame layer with auto-decrypt on and no key file tries, in order, the
common keys of the announced cipher, the frame as clear text, and the
first five common keys of every other cipher; it scores each plaintext
for plausibility, stops at the first that scores 150 or more, and keeps
the best if it scores 80 or more.  This module is the benchmark's own
statement of that rule (the key list, the order and the score, as the
program's frame decoder defines them), on the frozen parsers and TEA of
``tebench.frozen``.
"""

from __future__ import annotations

import numpy as np

from tebench.frozen import burst, crc
from tebench.frozen.mac import MacParser, PDUType
from tebench.frozen.tea import TEADecryptor

FAMILIES = ("TEA1", "TEA2", "TEA3", "TEA4")


def common_keys() -> dict:
    def h(s):
        return bytes.fromhex(s)
    tea1 = [h(k) for k in (
        "00000000000000000000", "FFFFFFFFFFFFFFFFFFFF",
        "0123456789ABCDEF0123", "FEDCBA9876543210FEDC",
        "11111111111111111111", "AAAAAAAAAAAAAAAAAAAA",
        "55555555555555555555", "00010203040506070809",
        "1234567890ABCDEF1234", "DEADBEEFCAFEBABEFACE",
        "A0B1C2D3E4F506172839", "112233445566778899AA",
        "0F0F0F0F0F0F0F0F0F0F")]
    tea2 = [h(k) for k in (
        "00000000000000000000000000000000",
        "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF",
        "0123456789ABCDEF0123456789ABCDEF",
        "FEDCBA9876543210FEDCBA9876543210",
        "11111111111111111111111111111111",
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA",
        "55555555555555555555555555555555",
        "000102030405060708090A0B0C0D0E0F",
        "1234567890ABCDEF1234567890ABCDEF",
        "DEADBEEFCAFEBABEDEADBEEFCAFEBABE",
        "A0B1C2D3E4F5061728394A5B6C7D8E9F",
        "11223344556677889900112233445566")]
    tea34 = [h("00000000000000000000000000000000"),
             h("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF")]
    return {"TEA1": tea1, "TEA2": tea2, "TEA3": list(tea34),
            "TEA4": list(tea34)}


def score(plaintext: bytes) -> int:
    """Plausibility of a plaintext (higher is likelier clear text)."""
    parser = MacParser()
    s = 0
    s += sum(1 for b in plaintext if 32 <= b <= 126) * 2
    unique = len(set(plaintext))
    if unique > len(plaintext) // 8:
        s += 30
    if plaintext == b"\x00" * len(plaintext):
        s -= 50
    if plaintext == b"\xFF" * len(plaintext):
        s -= 50
    if len(plaintext) >= 4:
        first = plaintext[0]
        if first not in (0, 0xFF):
            s += 10
        if first in (0x01, 0x02, 0x03, 0x04, 0x05, 0x08, 0x0A, 0x0C):
            s += 20
    if unique > 1:
        s += 10
    try:
        text = parser.parse_sds_data(plaintext)
        if text:
            if text.startswith("[BIN-ENC]"):
                s -= 20
            elif text.startswith("[BIN]"):
                s += 40
            else:
                s += 120
    except Exception:
        pass
    try:
        bits = burst.bytes_to_bits(plaintext)
        if crc.soft_crc_check(bits):
            s += 100
        pdu = parser.parse_mac_pdu(bits)
        if pdu and pdu.pdu_type != PDUType.MAC_DATA:
            s += 50
    except Exception:
        pass
    return s


def plan(algorithm: str) -> list:
    """[(key or None for clear, family)] in the order they are tried."""
    keys = common_keys()
    out = [(k, algorithm) for k in keys.get(algorithm, [])]
    out.append((None, algorithm))
    for other in FAMILIES:
        if other != algorithm:
            out += [(k, other) for k in keys.get(other, [])[:5]]
    return out


def decision(payload: bytes, algorithm: str) -> dict:
    """{"decrypted": bool, "plaintext": bytes | None, "key": bytes | None,
    "clear": bool} for an encrypted payload announced as ``algorithm``."""
    payload = bytes(payload)
    if len(payload) < 8:
        return {"decrypted": False, "plaintext": None, "key": None,
                "clear": False}
    payload += b"\x00" * (-len(payload) % 8)
    best, best_score = None, 0
    for key, fam in plan(algorithm):
        plain = (payload if key is None
                 else TEADecryptor(key, fam).decrypt(payload))
        sc = score(plain)
        if sc > best_score:
            best_score, best = sc, (plain, key)
        if sc >= 150:
            break
    if best is None or best_score < 80:
        return {"decrypted": False, "plaintext": None, "key": None,
                "clear": False}
    plain, key = best
    if key is None:
        return {"decrypted": False, "plaintext": None, "key": None,
                "clear": True}
    return {"decrypted": True, "plaintext": plain, "key": key,
            "clear": False}


def encrypt(plaintext: bytes, key: bytes, algorithm: str) -> bytes:
    return TEADecryptor(key, algorithm).encrypt(plaintext)


def bits_of(data: bytes) -> np.ndarray:
    return burst.bytes_to_bits(data)
