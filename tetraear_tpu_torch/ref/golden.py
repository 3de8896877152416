"""Golden TETRA slots and streams for end-to-end tests and benches.

The reference repo has no transmitter and no golden vectors — its tests only
assert shapes/ranges (SURVEY.md section 4 gap).  This module builds 510-bit
slots that are *fully consistent* with the receive chain:

  * the 22-bit downlink sync word sits at slot bits 216..237 so the sync
    searcher fires (tetraear/core/decoder.py:863-877);
  * the data view bits[0:108] ++ bits[122:230] parses as a MAC-RESOURCE PDU
    (tetraear/core/protocol.py:399-449);
  * the data view passes the soft CRC-16 gate (protocol.py:292-329).

The last point is subtle: 14 of the 16 CRC bits are *forced* by the sync
overlap (slot bits 216..229 are both sync word and the CRC tail of the data
view), so the construction searches filler bits until the payload's CRC agrees
with the forced pattern within the gate's 2-bit error budget.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.frame import burst as burst_mod
from tetraear_tpu_torch.frame import crc as crc_mod
from tetraear_tpu_torch.ref import modulator

SLOT_BITS = 510
DATA_BITS = 216           # len(bits[0:108]) + len(bits[122:230])
SYNC_AT = 216             # sync word position within the slot


def _data_to_slot_index(j: int) -> int:
    """Map data-view index (0..215) to slot bit index."""
    return j if j < 108 else 122 + (j - 108)


def build_mac_resource_data_bits(payload: bytes, address: int = 0x123456,
                                 rng: np.random.Generator | None = None,
                                 max_tries: int = 20000,
                                 enc_mode: int = 0) -> np.ndarray:
    """216-bit data view: MAC-RESOURCE header + payload + CRC, where the CRC
    tail agrees (<=2 bit errors) with the sync word that will overlay it.

    enc_mode: MAC encryption-mode bits (0 clear, 1 SCK, 2 DCK); pass an
    already-encrypted payload when nonzero."""
    rng = rng or np.random.default_rng(0)
    sync = burst_mod.SYNC_CONTINUOUS_DOWNLINK

    header = np.zeros(5, dtype=np.uint8)          # type=00 enc fill=0
    header[2] = (enc_mode >> 1) & 1
    header[3] = enc_mode & 1
    addr_bits = np.array([(address >> i) & 1 for i in range(23, -1, -1)],
                         dtype=np.uint8)
    n_payload = len(payload)
    if n_payload > 63:
        raise ValueError("payload too long for 6-bit length field")
    len_bits = np.array([(n_payload >> i) & 1 for i in range(5, -1, -1)],
                        dtype=np.uint8)
    payload_bits = burst_mod.bytes_to_bits(payload)
    fixed = np.concatenate([header, addr_bits, len_bits, payload_bits])
    if len(fixed) > 200:
        raise ValueError("payload too long to fit before the CRC field")

    free = 200 - len(fixed)
    # CRC bits 2..15 are forced to sync[0:14] by the overlay; search filler
    # until the computed CRC matches within the soft gate's budget.
    target = sync[:14]
    for _ in range(max_tries):
        filler = rng.integers(0, 2, free).astype(np.uint8)
        body = np.concatenate([fixed, filler])
        crc = crc_mod.crc16_batch(body)[0]
        if int(np.sum(crc[2:16] != target)) <= 2:
            data = np.concatenate([body, crc])
            data[202:216] = target        # overlay wins; <=2 errors remain
            return data
    raise RuntimeError("golden CRC search failed; increase max_tries")


def _solve_crc_tail(fixed: np.ndarray,
                    rng: np.random.Generator,
                    max_tries: int = 20000) -> np.ndarray:
    """Fill [fixed | filler | crc] to 216 bits with the sync-overlay CRC
    constraint satisfied (shared by all golden data-view constructors)."""
    sync = burst_mod.SYNC_CONTINUOUS_DOWNLINK
    if len(fixed) > 200:
        raise ValueError("fixed part too long")
    free = 200 - len(fixed)
    target = sync[:14]
    for _ in range(max_tries):
        filler = rng.integers(0, 2, free).astype(np.uint8)
        body = np.concatenate([fixed, filler])
        crc = crc_mod.crc16_batch(body)[0]
        if int(np.sum(crc[2:16] != target)) <= 2:
            data = np.concatenate([body, crc])
            data[202:216] = target
            return data
    raise RuntimeError("golden CRC search failed; increase max_tries")


def build_broadcast_data_bits(mcc: int = 260, mnc: int = 99,
                              colour_code: int = 5,
                              rng: np.random.Generator | None = None
                              ) -> np.ndarray:
    """216-bit data view for a MAC-BROADCAST SYSINFO slot: type=10,
    broadcast-type=00, MCC(10), MNC(14), CC(6)
    (tetraear/core/protocol.py:471-498 layout)."""
    rng = rng or np.random.default_rng(0)
    fixed = np.zeros(34, dtype=np.uint8)
    fixed[0] = 1                                   # pdu type = 10
    for i in range(10):
        fixed[4 + i] = (mcc >> (9 - i)) & 1
    for i in range(14):
        fixed[14 + i] = (mnc >> (13 - i)) & 1
    for i in range(6):
        fixed[28 + i] = (colour_code >> (5 - i)) & 1
    return _solve_crc_tail(fixed, rng)


def build_slot(data_bits: np.ndarray,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """Scatter a 216-bit data view into a 510-bit slot + sync word."""
    rng = rng or np.random.default_rng(1)
    slot = rng.integers(0, 2, SLOT_BITS).astype(np.uint8)
    for j in range(DATA_BITS):
        slot[_data_to_slot_index(j)] = data_bits[j]
    slot[SYNC_AT:SYNC_AT + 22] = burst_mod.SYNC_CONTINUOUS_DOWNLINK
    return slot


def build_stream(payloads: list, address: int = 0x123456,
                 seed: int = 0, sysinfo_every: int = 0,
                 mcc: int = 260, mnc: int = 99) -> np.ndarray:
    """Concatenate golden slots (one per payload) into a bit stream.

    sysinfo_every > 0 interleaves a MAC-BROADCAST SYSINFO slot before every
    n-th payload slot, like a real downlink's periodic network broadcast.
    """
    rng = np.random.default_rng(seed)
    slots = []
    for i, p in enumerate(payloads):
        if sysinfo_every and i % sysinfo_every == 0:
            data = build_broadcast_data_bits(mcc=mcc, mnc=mnc, rng=rng)
            slots.append(build_slot(data, rng=rng))
        data = build_mac_resource_data_bits(p, address=address, rng=rng)
        slots.append(build_slot(data, rng=rng))
    return np.concatenate(slots)


def golden_iq(payloads: list, fs: float = 2.4e6,
              freq_offset_hz: float = 0.0, snr_db: float | None = None,
              seed: int = 0, lead_in_bits: int = 64) -> np.ndarray:
    """Full golden capture: payloads -> slots -> pi/4-DQPSK IQ at fs.

    lead_in_bits of random padding precede the first slot so filter warmup
    does not eat slot 0.
    """
    rng = np.random.default_rng(seed + 99)
    bits = build_stream(payloads, seed=seed)
    pad = rng.integers(0, 2, lead_in_bits).astype(np.uint8)
    tail = rng.integers(0, 2, 256).astype(np.uint8)
    all_bits = np.concatenate([pad, bits, tail])
    return modulator.generate_carrier(
        all_bits, fs=fs, freq_offset_hz=freq_offset_hz, snr_db=snr_db,
        rng=np.random.default_rng(seed + 7))


def build_voice_slot(coded_bits: np.ndarray,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """510-bit traffic slot carrying 432 channel-coded voice bits.

    Layout per the voice extractor (tetraear/ui/modern.py:2329-2356):
    payload symbols 0..107 (bits 0..215) and 119..226 (bits 238..453),
    training/sync at symbols 108..118 (bits 216..237).  The slot header
    bits [0:4] are forced to 0100 (MAC-FRAG, clear) so the frame decoder
    routes it to the voice path — the convolutional channel code absorbs
    those 4 overwritten coded bits.
    """
    rng = rng or np.random.default_rng(2)
    coded_bits = np.asarray(coded_bits, dtype=np.uint8)
    if len(coded_bits) != 432:
        raise ValueError("expected 432 coded bits")
    slot = rng.integers(0, 2, SLOT_BITS).astype(np.uint8)
    slot[0:216] = coded_bits[0:216]
    slot[SYNC_AT:SYNC_AT + 22] = burst_mod.SYNC_CONTINUOUS_DOWNLINK
    slot[238:238 + 216] = coded_bits[216:432]
    slot[0:4] = [0, 1, 0, 0]          # MAC-FRAG, clear
    return slot


def build_stolen_voice_slot(coded_bits: np.ndarray,
                            rng: np.random.Generator | None = None
                            ) -> np.ndarray:
    """510-bit frame-stealing slot: STCH block 1 + half-slot voice block 2.

    Normal training sequence 2 (the reference's SYNC_DISCONTINUOUS_DOWNLINK,
    protocol.py:163) marks block 1 as stolen per ETSI EN 300 392-2
    §9.4.4.3.2; block 2 (bits 238..453) carries the 216
    half-slot-channel-coded bits of one speech frame (EN 300 395-2 §5).
    Block 1 here is filler STCH signalling with a MAC-FRAG clear header so
    the voice-candidate gate passes.
    """
    rng = rng or np.random.default_rng(3)
    coded_bits = np.asarray(coded_bits, dtype=np.uint8)
    if len(coded_bits) != 216:
        raise ValueError("expected 216 half-slot coded bits")
    slot = rng.integers(0, 2, SLOT_BITS).astype(np.uint8)
    slot[SYNC_AT:SYNC_AT + 22] = burst_mod.SYNC_DISCONTINUOUS_DOWNLINK
    slot[238:238 + 216] = coded_bits
    slot[0:4] = [0, 1, 0, 0]          # MAC-FRAG, clear
    return slot


def golden_voice_iq(pcm_frames: np.ndarray, fs: float = 2.4e6,
                    snr_db: float | None = None, seed: int = 0,
                    lead_in_bits: int = 64,
                    stolen_every: int = 0) -> np.ndarray:
    """Speech PCM -> ACELP+channel encode -> traffic slots -> IQ.

    pcm_frames: int16 array, length a multiple of 480 (two 30 ms speech
    frames per slot).  Requires the native codec library.

    stolen_every > 0 makes every Nth slot a frame-stealing slot: its
    first speech frame is dropped (stolen for STCH) and the second is
    transmitted half-slot-coded under normal training sequence 2
    (EN 300 395-2 §5); the encoder state stays continuous so pitch
    tracking across stolen slots is exercised.
    """
    import ctypes

    from tetraear_tpu_torch.voice import codec as vcodec

    vp = vcodec.VoiceProcessor()
    if not vp.working:
        raise RuntimeError("voice codec library not built")
    lib = vp._lib
    enc = lib.tetra_speech_encoder_new()
    rng = np.random.default_rng(seed + 99)
    slots = []
    try:
        pcm_frames = np.asarray(pcm_frames, np.int16)
        n_slots = len(pcm_frames) // 480
        for si in range(n_slots):
            params = np.zeros((2, 138), np.int16)
            for f in range(2):
                seg = np.ascontiguousarray(
                    pcm_frames[si * 480 + f * 240: si * 480 + (f + 1) * 240])
                lib.tetra_speech_encode(
                    enc, seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    params[f].ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            if stolen_every and si % stolen_every == stolen_every - 1:
                soft216 = np.zeros(216, np.int16)
                lib.tetra_channel_encode_stolen(
                    np.ascontiguousarray(params[1, 1:]).ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int16)),
                    soft216.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
                coded = (soft216 < 0).astype(np.uint8)
                slots.append(build_stolen_voice_slot(coded, rng=rng))
                continue
            block = np.zeros(vcodec.CODEC_BLOCK_WORDS, np.int16)
            lib.tetra_channel_encode(
                np.ascontiguousarray(params).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int16)),
                block.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            # block words -> 432 coded bits (soft +-127 -> hard)
            soft = np.concatenate([block[1:115], block[116:230],
                                   block[231:345], block[346:436]])
            coded = (soft[:432] > 0).astype(np.uint8)
            slots.append(build_voice_slot(coded, rng=rng))
    finally:
        lib.tetra_speech_encoder_free(enc)

    pad = rng.integers(0, 2, lead_in_bits).astype(np.uint8)
    tail = rng.integers(0, 2, 256).astype(np.uint8)
    all_bits = np.concatenate([pad] + slots + [tail])
    return modulator.generate_carrier(
        all_bits, fs=fs, snr_db=snr_db, rng=np.random.default_rng(seed + 7))


def sds_text_payload(text: str, pid: int = 0x82) -> bytes:
    """SDS-TL text payload the SDS layer decodes as [TXT] (low byte
    diversity keeps the decoder's entropy gate happy, decoder.py:1037-1049).
    """
    return bytes([pid]) + text.encode("latin-1")
