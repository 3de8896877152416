"""TETRA Encryption Algorithm (TEA1-4) stand-ins + key management.

Semantics match the reference's simplified TEA variants bit-for-bit
(tetraear/core/crypto.py:88-268) — like the reference, these are TEA-like
stand-ins, NOT the proprietary ETSI algorithms (stated at crypto.py:92-94).
Differences from the reference implementation:

  * block operations are vectorized over all 8-byte blocks at once with
    uint32 NumPy arithmetic instead of a per-block Python loop, which is also
    the formulation the batched JAX key-search kernel uses
    (tetraear_tpu_torch.crypto.batch);
  * encryption (the exact inverse of each decryption) is provided so
    round-trip tests and golden encrypted fixtures are possible — the
    reference ships decrypt-only and therefore cannot test itself.

Key lengths: TEA1 = 80 bits, TEA2/3/4 = 128 bits (crypto.py:43-48).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

_DELTA = np.uint32(0x9E3779B9)
_SUM0 = np.uint32((0x9E3779B9 * 32) & 0xFFFFFFFF)

KEY_LENGTHS = {"TEA1": 80, "TEA2": 128, "TEA3": 128, "TEA4": 128}


def _split_blocks(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> (v0, v1) big-endian uint32 word pairs per 8-byte block."""
    arr = np.frombuffer(bytes(data), dtype=">u4").reshape(-1, 2)
    return arr[:, 0].astype(np.uint32), arr[:, 1].astype(np.uint32)


def _join_blocks(v0: np.ndarray, v1: np.ndarray) -> bytes:
    out = np.empty((len(v0), 2), dtype=">u4")
    out[:, 0] = v0
    out[:, 1] = v1
    return out.tobytes()


def _tea1_keywords(key: bytes) -> np.ndarray:
    """80-bit key as five big-endian uint16 words (only words 0-3 are ever
    indexed, mirroring crypto.py:108-110, 120-123)."""
    return np.frombuffer(bytes(key), dtype=">u2").astype(np.uint32)


def _tea1_f0(v: np.ndarray, s: np.uint32, kw: np.ndarray) -> np.ndarray:
    return (((v << np.uint32(4)) ^ (v >> np.uint32(5)) ^ s) + v) ^ (
        kw[int(s) & 3] + s)


def _tea1_f1(v: np.ndarray, s: np.uint32, kw: np.ndarray) -> np.ndarray:
    return (((v << np.uint32(4)) ^ (v >> np.uint32(5)) ^ s) + v) ^ (
        kw[(int(s) >> 11) & 3] + s)


def tea1_decrypt_blocks(data: bytes, key: bytes) -> bytes:
    """TEA1 (80-bit) decryption, all blocks in parallel (crypto.py:88-126)."""
    kw = _tea1_keywords(key)
    v0, v1 = _split_blocks(data)
    s = _SUM0
    with np.errstate(over="ignore"):
        for _ in range(32):
            v1 = v1 - _tea1_f1(v0, s, kw)
            s = s - _DELTA
            v0 = v0 - _tea1_f0(v1, s, kw)
    return _join_blocks(v0, v1)


def tea1_encrypt_blocks(data: bytes, key: bytes) -> bytes:
    """Exact inverse of tea1_decrypt_blocks (new; for tests/fixtures)."""
    kw = _tea1_keywords(key)
    v0, v1 = _split_blocks(data)
    s = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(32):
            v0 = v0 + _tea1_f0(v1, s, kw)
            s = s + _DELTA
            v1 = v1 + _tea1_f1(v0, s, kw)
    return _join_blocks(v0, v1)


def _tea2_keywords(key: bytes) -> tuple:
    k = np.frombuffer(bytes(key), dtype=">u4").astype(np.uint32)
    return k[0], k[1], k[2], k[3]


def tea2_decrypt_blocks(data: bytes, key: bytes) -> bytes:
    """TEA2: classic-TEA-style decrypt rounds with the reference's mid-round
    sum decrement (crypto.py:128-163)."""
    k0, k1, k2, k3 = _tea2_keywords(key)
    v0, v1 = _split_blocks(data)
    s = _SUM0
    four, five = np.uint32(4), np.uint32(5)
    with np.errstate(over="ignore"):
        for _ in range(32):
            v1 = v1 - (((v0 << four) + k2) ^ (v0 + s) ^ ((v0 >> five) + k3))
            s = s - _DELTA
            v0 = v0 - (((v1 << four) + k0) ^ (v1 + s) ^ ((v1 >> five) + k1))
    return _join_blocks(v0, v1)


def tea2_encrypt_blocks(data: bytes, key: bytes) -> bytes:
    k0, k1, k2, k3 = _tea2_keywords(key)
    v0, v1 = _split_blocks(data)
    s = np.uint32(0)
    four, five = np.uint32(4), np.uint32(5)
    with np.errstate(over="ignore"):
        for _ in range(32):
            v0 = v0 + (((v1 << four) + k0) ^ (v1 + s) ^ ((v1 >> five) + k1))
            s = s + _DELTA
            v1 = v1 + (((v0 << four) + k2) ^ (v0 + s) ^ ((v0 >> five) + k3))
    return _join_blocks(v0, v1)


# TEA3/TEA4 alias the TEA2 structure, as in the reference
# (crypto.py:165-195).
_DECRYPT = {
    "TEA1": tea1_decrypt_blocks,
    "TEA2": tea2_decrypt_blocks,
    "TEA3": tea2_decrypt_blocks,
    "TEA4": tea2_decrypt_blocks,
}
_ENCRYPT = {
    "TEA1": tea1_encrypt_blocks,
    "TEA2": tea2_encrypt_blocks,
    "TEA3": tea2_encrypt_blocks,
    "TEA4": tea2_encrypt_blocks,
}


class TEADecryptor:
    """Drop-in equivalent of the reference TEADecryptor (crypto.py:25-268)."""

    KEY_LENGTHS = KEY_LENGTHS

    def __init__(self, key: bytes, algorithm: str = "TEA1"):
        self.algorithm = algorithm.upper()
        self.key = bytes(key)
        expected = KEY_LENGTHS.get(self.algorithm)
        if expected is None:
            raise ValueError(f"Unknown algorithm: {self.algorithm}")
        if len(self.key) * 8 != expected:
            raise ValueError(
                f"Key length mismatch for {self.algorithm}: expected "
                f"{expected} bits, got {len(self.key) * 8} bits")

    def decrypt_block(self, block: bytes) -> bytes:
        if len(block) != 8:
            raise ValueError(f"{self.algorithm} block must be 8 bytes")
        return _DECRYPT[self.algorithm](block, self.key)

    def encrypt_block(self, block: bytes) -> bytes:
        if len(block) != 8:
            raise ValueError(f"{self.algorithm} block must be 8 bytes")
        return _ENCRYPT[self.algorithm](block, self.key)

    def decrypt(self, data: bytes, iv: bytes | None = None) -> bytes:
        """ECB (iv=None) or CBC decryption over 8-byte blocks."""
        if len(data) % 8 != 0:
            raise ValueError("Data length must be multiple of 8 bytes")
        plain = _DECRYPT[self.algorithm](data, self.key)
        if iv is None:
            return plain
        if len(iv) != 8:
            raise ValueError("IV must be 8 bytes")
        # CBC: xor each decrypted block with the previous ciphertext block.
        prev = np.frombuffer(iv + data[:-8], dtype=np.uint8)
        out = np.frombuffer(plain, dtype=np.uint8) ^ prev
        return out.tobytes()

    def encrypt(self, data: bytes, iv: bytes | None = None) -> bytes:
        if len(data) % 8 != 0:
            raise ValueError("Data length must be multiple of 8 bytes")
        if iv is None:
            return _ENCRYPT[self.algorithm](data, self.key)
        if len(iv) != 8:
            raise ValueError("IV must be 8 bytes")
        out = bytearray()
        prev = iv
        for i in range(0, len(data), 8):
            blk = bytes(a ^ b for a, b in zip(data[i:i + 8], prev))
            prev = _ENCRYPT[self.algorithm](blk, self.key)
            out.extend(prev)
        return bytes(out)


class TetraKeyManager:
    """Key storage + ALG:KEY_ID:HEX key-file loader (crypto.py:271-411)."""

    def __init__(self):
        self.keys: dict = {}

    def load_key_file(self, filepath: str) -> None:
        with open(filepath, "r", encoding="utf-8") as f:
            for line_num, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(":")
                if len(parts) != 3:
                    logger.warning("Invalid key format at line %d: %s",
                                   line_num, line)
                    continue
                try:
                    algorithm, key_id, hex_key = parts
                    self.add_key(algorithm, key_id, bytes.fromhex(hex_key))
                    logger.info("Loaded %s key %s", algorithm.upper(),
                                key_id)
                except ValueError as e:
                    logger.warning("Error parsing key at line %d: %s",
                                   line_num, e)

    def get_key(self, algorithm: str, key_id: str = "0") -> bytes | None:
        return self.keys.get(algorithm.upper(), {}).get(key_id)

    def add_key(self, algorithm: str, key_id: str, key: bytes) -> None:
        self.keys.setdefault(algorithm.upper(), {})[key_id] = key

    def has_key(self, algorithm: str, key_id: str = "0") -> bool:
        return key_id in self.keys.get(algorithm.upper(), {})
