"""TETRA frame decoder: sync search, frame decode, decrypt orchestration.

Behavioural equivalent of the reference decoder (tetraear/core/decoder.py),
with the hot paths vectorized:

  * sync correlation is one sliding-window comparison over the whole bit
    stream instead of a per-position Python loop (decoder.py:231-259) — and
    the same correlation array drives the threshold cascade and the adaptive
    threshold without re-scanning;
  * frame dictionaries carry the same keys as the reference so downstream
    consumers (validator, UI, JSONL logs, offline tools) are drop-in.

The device path computes the same correlations on device for thousands of
carriers at once (tetraear_tpu_torch.dsp.sync); this host implementation is the
oracle and the single-carrier fallback.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np

from tetraear_tpu_torch.crypto.tea import TEADecryptor, TetraKeyManager
from tetraear_tpu_torch.frame import burst as burst_mod
from tetraear_tpu_torch.frame import crc as crc_mod
from tetraear_tpu_torch.frame import sds as sds_mod
from tetraear_tpu_torch.frame.mac import (MacFields, MacParser, PDUType,
                                         extract_mac_fields)

logger = logging.getLogger(__name__)

FRAME_LENGTH = 510        # bits per slot/frame
SYNC_LEN = 22
SYNC_SKIP = 250           # dedup distance after a sync hit (decoder.py:256)
TS_OFFSET_BITS = 216      # training sequence position within the slot

SYNC_PATTERNS = {
    "TS1": burst_mod.SYNC_CONTINUOUS_DOWNLINK,
    "TS2": burst_mod.SYNC_DISCONTINUOUS_DOWNLINK,
}

# 31-bit scanner sync pattern (decoder.py:28-29)
SCANNER_SYNC_PATTERN = np.array(
    [0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1,
     1, 0, 0, 0, 1, 0, 0], dtype=np.uint8)

_FRAME_TYPE_NAMES = {
    0: ("MAC-RESOURCE", "Resource allocation"),
    1: ("MAC-FRAG", "Fragment"),
    2: ("MAC-BROADCAST", "Broadcast info"),
    3: ("MAC-END/RES", "End/Reserved"),
}


def common_keys() -> dict:
    """Built-in common/weak keys for auto-decrypt bruteforce
    (decoder.py:36-99).  Null keys, test patterns, repeated-nibble weak keys
    and a handful of widely published manufacturer/network defaults."""
    def h(s):
        return bytes.fromhex(s)
    tea1 = [
        h("00000000000000000000"), h("FFFFFFFFFFFFFFFFFFFF"),
        h("0123456789ABCDEF0123"), h("FEDCBA9876543210FEDC"),
        h("11111111111111111111"), h("AAAAAAAAAAAAAAAAAAAA"),
        h("55555555555555555555"), h("00010203040506070809"),
        h("1234567890ABCDEF1234"), h("DEADBEEFCAFEBABEFACE"),
        h("A0B1C2D3E4F506172839"), h("112233445566778899AA"),
        h("0F0F0F0F0F0F0F0F0F0F"),
    ]
    tea2 = [
        h("00000000000000000000000000000000"),
        h("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
        h("0123456789ABCDEF0123456789ABCDEF"),
        h("FEDCBA9876543210FEDCBA9876543210"),
        h("11111111111111111111111111111111"),
        h("AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"),
        h("55555555555555555555555555555555"),
        h("000102030405060708090A0B0C0D0E0F"),
        h("1234567890ABCDEF1234567890ABCDEF"),
        h("DEADBEEFCAFEBABEDEADBEEFCAFEBABE"),
        h("A0B1C2D3E4F5061728394A5B6C7D8E9F"),
        h("11223344556677889900112233445566"),
    ]
    tea34 = [
        h("00000000000000000000000000000000"),
        h("FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
    ]
    return {"TEA1": tea1, "TEA2": tea2, "TEA3": list(tea34),
            "TEA4": list(tea34)}


def sync_correlate(bits: np.ndarray) -> np.ndarray:
    """Best TS1/TS2 agreement ratio at every window position -> (N-21,)."""
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < SYNC_LEN:
        return np.zeros(0, dtype=np.float32)
    win = np.lib.stride_tricks.sliding_window_view(bits, SYNC_LEN)
    best = np.zeros(win.shape[0], dtype=np.float32)
    for pat in SYNC_PATTERNS.values():
        corr = np.mean(win == pat[None, :], axis=1, dtype=np.float32)
        np.maximum(best, corr, out=best)
    return best


def greedy_positions(corr: np.ndarray, threshold: float,
                     min_gap: int = SYNC_SKIP, stride: int = 1) -> list:
    """Ascending greedy hit selection with skip-ahead dedup
    (decoder.py:231-259 / 270-281 semantics).

    ``stride``: bit distance between adjacent ``corr`` elements (2 for
    the even-position device scan).  Returned positions are always BIT
    positions; the dedup gap is applied in bit units."""
    hits = np.flatnonzero(corr >= threshold) * stride
    out: list = []
    last = -min_gap
    for pos in hits:
        if pos >= last + min_gap:
            out.append(int(pos))
            last = pos
    return out


def find_sync_in_corr(corr: np.ndarray, threshold: float = 0.85,
                      stride: int = 1) -> tuple:
    """Threshold + adaptive-fallback selection on a precomputed
    correlation array; returns (positions, max_corr)."""
    if len(corr) == 0:
        return [], 0.0
    max_corr = float(corr.max())
    positions = greedy_positions(corr, threshold, stride=stride)
    if not positions and max_corr > 0.75 and max_corr >= threshold - 0.15:
        adaptive = max(0.75, max_corr - 0.02)
        if adaptive < threshold:
            positions = greedy_positions(corr, adaptive, stride=stride)
    return positions, max_corr


def find_sync(bits: np.ndarray, threshold: float = 0.85,
              return_max_corr: bool = False):
    """Threshold + adaptive-fallback sync search (decoder.py:171-295)."""
    positions, max_corr = find_sync_in_corr(sync_correlate(bits), threshold)
    if return_max_corr:
        return positions, max_corr
    return positions


def sync_cascade(corr: np.ndarray, stride: int = 1) -> list:
    """The full multi-threshold sync cascade of TetraDecoder.decode
    (reference decoder.py:843-857), on a precomputed correlation array.

    Shared by the host decode path and the batched device frame layer
    (frame.batch) so both select identical positions.  ``stride`` is
    the bit distance between corr elements (2 for the even-position
    scan); returned positions are bit positions."""
    positions, max_corr = find_sync_in_corr(corr, 0.90, stride=stride)
    if not positions:
        positions, max_corr = find_sync_in_corr(corr, 0.85, stride=stride)
    if not positions:
        positions, max_corr = find_sync_in_corr(corr, 0.80, stride=stride)
    if not positions and max_corr >= 0.75:
        adaptive = max(0.75, max_corr - 0.02)
        positions = greedy_positions(corr, adaptive, stride=stride)
    return positions


_BYTE_BITS = tuple(format(b, "08b") for b in range(256))
FIRST_BONUS = (0x01, 0x02, 0x03, 0x04, 0x05, 0x08, 0x0A, 0x0C)


class Scored(NamedTuple):
    """score_plaintext's result: the score, the plaintext's MAC fields
    (None where extract_mac_fields finds none) and the data messages
    its SDS parse counts (0 or 1)."""
    score: int
    fields: MacFields | None
    data_messages: int


def score_plaintext(plaintext: bytes) -> Scored:
    """TetraDecoder._score_decrypt without a parser: the score, and what
    scoring does to the scoring decoder's parser (apply_score_effects).
    The SDS parse counts into a scratch dict; the MAC PDU is extracted,
    not applied (apply_mac_fields never makes a MAC_DATA PDU, so every
    PDU extracted earns the bonus)."""
    score = 0
    printable = sum(1 for b in plaintext if 32 <= b <= 126)
    score += printable * 2
    unique = len(set(plaintext))
    if unique > len(plaintext) // 8:
        score += 30
    if plaintext == b"\x00" * len(plaintext):
        score -= 50
    if plaintext == b"\xFF" * len(plaintext):
        score -= 50
    if len(plaintext) >= 4:
        first = plaintext[0]
        if first not in (0, 0xFF):
            score += 10
        if first in FIRST_BONUS:
            score += 20
    if unique > 1:
        score += 10
    stats = {"data_messages": 0}
    try:
        sds_text = sds_mod.parse_sds_data(plaintext, stats=stats)
        if sds_text:
            if sds_text.startswith("[BIN-ENC]"):
                score -= 20
            elif sds_text.startswith("[BIN]"):
                score += 40
            else:
                score += 120
    except Exception:
        pass
    fields = None
    try:
        bits = burst_mod.bytes_to_bits(plaintext)
        if crc_mod.soft_crc_check(bits):
            score += 100
        fields = extract_mac_fields(bits)
        if fields is not None:
            score += 50
    except Exception:
        pass
    return Scored(score, fields, stats["data_messages"])


def apply_score_effects(parser: MacParser, scored: Scored) -> None:
    """What scoring a plaintext does to the scoring decoder's parser: the
    SDS parse's data messages, and the MAC PDU applied."""
    parser.stats["data_messages"] += scored.data_messages
    if scored.fields is not None:
        parser.apply_mac_fields(scored.fields)


def replay_score_effects(parser: MacParser, data_messages: int,
                         pdus: list, last: int, fields_at) -> None:
    """apply_score_effects of plaintexts scored in turn, from what their
    scores kept (the records of crypto/keyscore.py): the data messages
    they count, and their MAC PDUs replayed (MacParser.replay_mac_fields
    with ``pdus``, ``last`` and ``fields_at``)."""
    parser.stats["data_messages"] += data_messages
    parser.replay_mac_fields(pdus, last, fields_at)


class TetraDecoder:
    """Drop-in equivalent of the reference TetraDecoder (decoder.py:16)."""

    FRAME_LENGTH = FRAME_LENGTH

    def __init__(self, key_manager: TetraKeyManager | None = None,
                 auto_decrypt: bool = True):
        self.key_manager = key_manager
        self.auto_decrypt = auto_decrypt
        self.defer_decrypt = False     # batched layer sets True (see
        self.protocol_parser = MacParser()  # frame.batch / crypto.batch)
        self.common_keys = common_keys()
        self.user_keys: list = []
        self.SYNC_PATTERN = SCANNER_SYNC_PATTERN.tolist()

    # -- keys -------------------------------------------------------------

    def set_keys(self, keys) -> None:
        """Load user hex keys; 10 bytes -> TEA1, 16 bytes -> TEA2/3/4
        cross-registered (decoder.py:101-138)."""
        self.user_keys = []
        for key_str in keys:
            try:
                key_str = (key_str.replace(" ", "").replace(":", "")
                           .replace("-", ""))
                kb = bytes.fromhex(key_str)
            except ValueError as e:
                logger.error("Failed to parse key '%s': %s", key_str, e)
                continue
            if len(kb) == 10:
                self.user_keys.append(("TEA1", kb))
            elif len(kb) == 16:
                for alg in ("TEA2", "TEA3", "TEA4"):
                    self.user_keys.append((alg, kb))
            elif len(kb) == 32:
                logger.warning("256-bit key provided; using first 128 bits")
                for alg in ("TEA2", "TEA3", "TEA4"):
                    self.user_keys.append((alg, kb[:16]))
            else:
                logger.warning("Invalid key length: %d bytes", len(kb))
        logger.info("Loaded %d user-provided encryption keys",
                    len(self.user_keys))

    # -- symbol/bit utilities ---------------------------------------------

    def symbols_to_bits(self, symbols) -> tuple:
        """(bits, mapped 0-3 symbols); accepts 0-3 or 0-7 (8-PSK) input
        (decoder.py:140-169)."""
        symbols = np.asarray(symbols)
        if len(symbols) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
        if symbols.max() <= 3:
            mapped = (symbols.astype(np.int64) & 0x3)
        else:
            lut = np.array([0, 0, 0, 1, 1, 3, 2, 2], dtype=np.int64)
            mapped = lut[np.clip(symbols.astype(np.int64), 0, 7)]
        bits = np.empty(2 * len(mapped), dtype=np.int64)
        bits[0::2] = mapped >> 1
        bits[1::2] = mapped & 1
        return bits, mapped

    def find_sync(self, bits, threshold: float = 0.85,
                  return_max_corr: bool = False):
        return find_sync(bits, threshold, return_max_corr)

    # -- top-level decode --------------------------------------------------

    def decode(self, symbols) -> list:
        """Symbol stream -> list of frame dicts (decoder.py:835-888)."""
        bits, mapped = self.symbols_to_bits(symbols)
        positions = sync_cascade(sync_correlate(bits))

        frames = []
        for pos in positions:
            start_pos = pos - TS_OFFSET_BITS
            if start_pos < 0:
                continue
            start_sym = start_pos // 2
            if start_sym + burst_mod.SYMBOLS_PER_SLOT > len(mapped):
                continue
            frame_symbols = mapped[start_sym:start_sym + 255]
            frame_bits = bits[start_pos:start_pos + FRAME_LENGTH]
            frame_number = start_pos // FRAME_LENGTH
            frame = self.decode_frame(frame_bits, 0, frame_symbols,
                                      frame_number=frame_number)
            if frame:
                frame["position"] = start_pos
                frames.append(frame)
        return frames

    # -- per-frame decode --------------------------------------------------

    def decode_frame(self, bits, start_pos=0, symbols=None,
                     frame_number: int = 0,
                     crc_hint: bool | None = None,
                     pre=None) -> dict | None:
        """Decode one 510-bit frame (decoder.py:890-1119).

        ``crc_hint``: device-precomputed burst CRC verdict (see
        burst.parse_burst).  ``pre``: a hitparse.HitPre with the
        window's stateless verdicts already computed by the native
        batch engine — skips burst typing / CRC / MAC field extraction
        and runs only the stateful remainder (identical results,
        tests/unit/test_hitparse.py)."""
        bits = np.asarray(bits)
        if len(bits) < FRAME_LENGTH:
            return None
        frame_bits = bits
        header_bits = frame_bits[:32]

        pdu_type_int = (int(frame_bits[0]) << 1) | int(frame_bits[1])
        enc_mode_int = (int(frame_bits[2]) << 1) | int(frame_bits[3])
        frame_type = pdu_type_int
        type_name, descr = _FRAME_TYPE_NAMES.get(
            frame_type, (f"Type {frame_type}", f"Raw type {frame_type}"))

        additional_info = {"description": descr}
        encrypted = enc_mode_int > 0
        encryption_algorithm = None
        if enc_mode_int == 1:
            encryption_algorithm = "TEA1"
            additional_info["encryption_mode"] = "Class 2 (SCK)"
        elif enc_mode_int == 2:
            encryption_algorithm = "TEA2"
            additional_info["encryption_mode"] = "Class 3 (DCK)"
        elif enc_mode_int == 3:
            encryption_algorithm = "TEA3"
            additional_info["encryption_mode"] = "Reserved"

        # Frame stealing (ETSI EN 300 392-2 §9.4.4.3.2): the two 22-bit
        # downlink sync words the reference labels "continuous" /
        # "discontinuous" (protocol.py:162-163) are in fact normal training
        # sequences 1 and 2 — NTS2 means block 1 of the slot is STOLEN for
        # signalling (STCH) and block 2 carries one half-slot-coded speech
        # frame (EN 300 395-2 §5 frame stealing).  The reference never acts
        # on this; we route stolen slots to the half-slot voice decoder.
        if pre is not None:
            stolen = bool(pre.stolen)
        else:
            ts_win = frame_bits[TS_OFFSET_BITS:TS_OFFSET_BITS + SYNC_LEN]
            m1, m2 = burst_mod.sync_agreement(ts_win)
            stolen = m2 > m1

        frame_data = {
            "type": frame_type,
            "type_name": type_name,
            "number": frame_number,
            "timeslot": frame_number % 4,
            "bits": frame_bits,
            "header": "".join(map(str, header_bits.tolist())),
            "position": start_pos,
            "encrypted": encrypted,
            "encryption_algorithm": encryption_algorithm,
            "key_id": "0",
            "stolen": stolen,
            "additional_info": additional_info,
        }

        if pre is not None:
            # stateless verdicts precomputed by the native batch engine
            # (frame.hitparse); run only the stateful MAC application
            stats = self.protocol_parser.stats
            stats["total_bursts"] += 1
            burst_crc = bool(pre.crc_ok)
            stats["crc_pass" if burst_crc else "crc_fail"] += 1
            mac_pdu = (self.protocol_parser.apply_mac_fields(pre.mac)
                       if pre.mac is not None else None)
        else:
            if symbols is None:
                burst = burst_mod.parse_burst_bits(
                    frame_bits, slot_number=frame_number % 4,
                    stats=self.protocol_parser.stats, crc_hint=crc_hint)
            else:
                burst = burst_mod.parse_burst(
                    np.asarray(symbols), slot_number=frame_number % 4,
                    stats=self.protocol_parser.stats, crc_hint=crc_hint)
            burst_crc = None if burst is None else burst.crc_ok
            mac_pdu = (self.protocol_parser.parse_mac_pdu(burst.data_bits)
                       if burst is not None else None)
        if burst_crc is not None:
            frame_data["burst_crc"] = burst_crc
            # alias for the validator, which reads 'crc_ok'
            # (the reference emits only 'burst_crc' while its validator
            # checks 'crc_ok' — decoder.py:992 vs validator.py:102, so the
            # CRC penalty never fires there)
            frame_data["crc_ok"] = burst_crc
            if mac_pdu is not None:
                frame_data["mac_pdu"] = {
                    "type": mac_pdu.pdu_type.name,
                    "encrypted": mac_pdu.encrypted,
                    "address": mac_pdu.address,
                    "length": mac_pdu.length,
                    "data": mac_pdu.data,
                }
                if mac_pdu.encrypted:
                    frame_data["encrypted"] = True
                    enc_mode = mac_pdu.encryption_mode
                    alg, mode_name = {
                        1: ("TEA1", "Class 2 (SCK)"),
                        2: ("TEA2", "Class 3 (DCK)"),
                        3: ("TEA3", "Reserved"),
                    }.get(enc_mode, ("TEA1", None))
                    frame_data["encryption_algorithm"] = alg
                    if mode_name:
                        additional_info["encryption_mode"] = mode_name
                else:
                    # Entropy heuristic on clear-flagged payloads
                    # (decoder.py:1037-1053).  Skipped for MAC-BROADCAST:
                    # SYSINFO neighbour-cell data is naturally high-entropy
                    # and never encrypted, but the reference still flags it
                    # and "decrypts" it to garbage.
                    data = mac_pdu.data
                    if mac_pdu.pdu_type == PDUType.MAC_BROADCAST:
                        frame_data["encrypted"] = False
                        frame_data["encryption_algorithm"] = None
                    elif len(data) > 0:
                        entropy_ratio = len(set(data)) / max(len(data), 1)
                        if entropy_ratio > 0.7 and len(data) > 8:
                            frame_data["encrypted"] = True
                            # entropy-only evidence; voice traffic looks
                            # random too, so downstream keeps the voice
                            # path open (decoder.py:453 analogue)
                            frame_data["encryption_suspected"] = True
                        else:
                            frame_data["encrypted"] = False
                            frame_data["encryption_algorithm"] = None
                    else:
                        frame_data["encrypted"] = False
                        frame_data["encryption_algorithm"] = None

                call_meta = self.protocol_parser.parse_call_metadata(mac_pdu)
                if call_meta:
                    frame_data["call_metadata"] = {
                        "call_type": call_meta.call_type,
                        "talkgroup_id": call_meta.talkgroup_id,
                        "source_ssi": call_meta.source_ssi,
                        "dest_ssi": call_meta.dest_ssi,
                        "channel": call_meta.channel_allocated,
                        "call_identifier": call_meta.call_identifier,
                        "priority": call_meta.call_priority,
                        "mcc": call_meta.mcc,
                        "mnc": call_meta.mnc,
                        "encryption": call_meta.encryption_enabled,
                        "encryption_alg": call_meta.encryption_algorithm,
                    }
                    if call_meta.talkgroup_id:
                        additional_info["talkgroup"] = call_meta.talkgroup_id
                    if call_meta.source_ssi:
                        additional_info["source_ssi"] = call_meta.source_ssi
                    if call_meta.mcc:
                        additional_info["mcc"] = call_meta.mcc
                    if call_meta.mnc:
                        additional_info["mnc"] = call_meta.mnc

                payload = (mac_pdu.reassembled_data
                           if mac_pdu.reassembled_data else mac_pdu.data)
                if not mac_pdu.encrypted and len(payload) > 0:
                    sds_text = self.protocol_parser.parse_sds_data(payload)
                    if sds_text and not sds_text.startswith("[BIN]"):
                        frame_data["sds_message"] = sds_text
                        frame_data["decoded_text"] = sds_text
                        additional_info["sds_text"] = sds_text[:50]
                        if mac_pdu.reassembled_data:
                            frame_data["is_reassembled"] = True
                            additional_info["description"] += " (Reassembled)"
            else:
                # Strict gate: unparseable MAC + failed CRC -> discard
                # (decoder.py:1092-1100).
                if not burst_crc:
                    return None

        # Only bruteforce when there is nothing readable already: the
        # entropy heuristic routinely flags short clear texts (unique-byte
        # ratio of normal prose edges over 0.7), and the reference then
        # lets any >=80-scoring garbage overwrite the good SDS
        # (decoder.py:1106-1117).
        readable_clear = bool(
            frame_data.get("sds_message")
            and not str(frame_data["sds_message"]).startswith("[BIN"))
        if (frame_data.get("encrypted") and not readable_clear
                and (self.key_manager or self.auto_decrypt)):
            if self.defer_decrypt:
                # the batched frame layer collects this block's pending
                # frames and runs ONE keys x frames device search
                # (crypto.batch), then finishes via finish_decrypt()
                frame_data["decryption_pending"] = True
            else:
                frame_data = self._decrypt_frame(frame_data)
                self._post_decrypt_sds(frame_data)
        return frame_data

    def _post_decrypt_sds(self, frame_data: dict) -> None:
        """SDS extraction from a successful decrypt (decoder.py:1106-1117)."""
        if frame_data.get("decrypted") and "decrypted_bytes" in frame_data:
            try:
                dec = bytes.fromhex(frame_data["decrypted_bytes"])
                sds_text = self.protocol_parser.parse_sds_data(dec)
                if sds_text:
                    frame_data["sds_message"] = sds_text
                    frame_data["decoded_text"] = sds_text
                    frame_data.setdefault("additional_info", {})[
                        "sds_text"] = sds_text[:50]
            except ValueError:
                pass

    # -- display -----------------------------------------------------------

    def format_frame_info(self, frame: dict) -> str:
        """Multi-line human-readable frame summary (decoder.py:1121-1187)."""
        lines = [f"Frame #{frame.get('number')} "
                 f"(Type: {frame.get('type_name', '?')})"]
        lines.append(f"  Position: {frame.get('position')}")
        header = frame.get("header", "")
        lines.append(f"  Header: {header[:32]}...")
        msg = frame.get("sds_message") or frame.get("decoded_text")
        if msg:
            lines.append(f"  Message: {msg}")
        if frame.get("encrypted"):
            lines.append(f"  [ENC] Encrypted: Yes "
                         f"({frame.get('encryption_algorithm', 'Unknown')})")
            if frame.get("decrypted"):
                extra = f" - {frame['key_used']}" if frame.get(
                    "key_used") else ""
                lines.append(f"  [DEC] Decrypted: Yes{extra}")
            else:
                err = frame.get("decryption_error")
                lines.append(f"  [ERR] Decrypted: No"
                             + (f" ({err})" if err else ""))
        else:
            lines.append("  [CLR] Encrypted: No")
            pdu = frame.get("mac_pdu") or {}
            data = pdu.get("data")
            if isinstance(data, (bytes, bytearray)) and data and not msg:
                printable = sum(1 for b in data
                                if 32 <= b <= 126 or b in (10, 13))
                if printable / len(data) > 0.7:
                    text = bytes(data).decode("latin-1",
                                              errors="replace").strip()
                    lines.append(f"  [TXT] Data: {text[:80]}")
                else:
                    lines.append(f"  [HEX] Data: {bytes(data).hex()[:64]}...")
        if frame.get("is_reassembled"):
            lines.append("  (Reassembled from fragments)")
        if frame.get("has_voice"):
            lines.append("  Contains voice data")
        return "\n".join(lines)

    # -- decryption bruteforce ---------------------------------------------

    def _score_decrypt(self, plaintext: bytes) -> int:
        """Plaintext plausibility score (decoder.py:698-768), fed to this
        decoder's parser: score_plaintext, then apply_score_effects."""
        scored = score_plaintext(plaintext)
        apply_score_effects(self.protocol_parser, scored)
        return scored.score

    def _build_key_plan(self, frame_data: dict):
        """Payload extraction + ordered key list (decoder.py:596-666).

        Returns (payload_bytes, keys_to_try) or None when the payload is
        too short (error fields already set)."""
        algorithm = frame_data.get("encryption_algorithm") or "TEA1"
        key_id = frame_data.get("key_id", "0")
        frame_data["decryption_attempted"] = True
        frame_data["keys_tried"] = 0
        frame_data["best_score"] = 0
        frame_data["best_key"] = None

        payload_bytes = None
        mac_pdu = frame_data.get("mac_pdu")
        if isinstance(mac_pdu, dict) and "data" in mac_pdu:
            d = mac_pdu["data"]
            if isinstance(d, (bytes, bytearray)):
                payload_bytes = bytes(d)
            elif isinstance(d, str):
                try:
                    payload_bytes = bytes.fromhex(d)
                except ValueError:
                    payload_bytes = None
        if payload_bytes is None:
            payload_bytes = burst_mod.bits_to_bytes(
                np.asarray(frame_data["bits"][32:], dtype=np.uint8))

        if len(payload_bytes) < 8:
            frame_data["decrypted"] = False
            frame_data["decryption_error"] = "Payload too short for decryption"
            return None
        if len(payload_bytes) % 8:
            payload_bytes += b"\x00" * (8 - len(payload_bytes) % 8)

        keys_to_try: list = []
        if self.key_manager and self.key_manager.has_key(algorithm, key_id):
            key = self.key_manager.get_key(algorithm, key_id)
            keys_to_try.append(
                (key, f"{algorithm} key_id={key_id} (from file)", algorithm))
        primary = [(k, f"{a} user_key_{i} (loaded)", a)
                   for i, (a, k) in enumerate(self.user_keys)
                   if a == algorithm]
        cross = [(k, f"{a} user_key_{i} (cross-try)", a)
                 for i, (a, k) in enumerate(self.user_keys)
                 if a != algorithm]
        keys_to_try[0:0] = primary
        for i, ck in enumerate(self.common_keys.get(algorithm, [])):
            keys_to_try.append((ck, f"{algorithm} common_key_{i}", algorithm))
        keys_to_try.append((None, "BYPASS (Treat as Clear)", algorithm))
        keys_to_try.extend(cross)
        for other in ("TEA1", "TEA2", "TEA3", "TEA4"):
            if other != algorithm:
                for i, ck in enumerate(self.common_keys.get(other, [])[:5]):
                    keys_to_try.append(
                        (ck, f"{other} common_key_{i} (cross-try)", other))
        return payload_bytes, keys_to_try

    def _select_decrypt(self, frame_data: dict, payload_bytes: bytes,
                        keys_to_try: list, plaintext_at=None) -> dict:
        """Score/select loop + result application (decoder.py:690-833).

        ``plaintext_at(i)`` supplies the i-th key's plaintext (host TEA
        without it).  The batched key search (crypto/batch.py) scores
        on the device instead and gives the same selection to
        _apply_decrypt."""
        best_result, best_score = None, 0
        for i, (key, desc, alg) in enumerate(keys_to_try):
            try:
                if key is None:
                    plain = payload_bytes
                elif plaintext_at is not None:
                    plain = plaintext_at(i)
                else:
                    plain = TEADecryptor(key, alg).decrypt(payload_bytes)
                score = self._score_decrypt(plain)
                if score > best_score:
                    best_score = score
                    best_result = (plain, desc)
                # Early-exit only on a confidently-readable decode.  The
                # reference breaks at score > 80 (decoder.py:777-779), but
                # random plaintext regularly crosses 80 on the printable
                # heuristics alone, so the break fires before the correct
                # key is ever tried; 150 requires the readable-SDS bonus.
                if score >= 150:
                    break
            except Exception:
                continue
        return self._apply_decrypt(frame_data, len(keys_to_try),
                                   best_result, best_score)

    def _apply_decrypt(self, frame_data: dict, n_keys: int, best_result,
                       best_score: int) -> dict:
        """The selection's result: ``best_result`` is the (plaintext, key
        description) of the first entry that reached the highest score
        of those scored (None when none scored above 0), taken at 80 or
        more."""
        frame_data["keys_tried"] = n_keys
        if best_result is not None:
            frame_data["best_score"] = best_score
            frame_data["best_key"] = best_result[1]
        if best_result and best_score >= 80:
            plain, desc = best_result
            if desc.startswith("BYPASS"):
                frame_data.update(bypass_clear=True, encrypted=False,
                                  encryption_algorithm=None, decrypted=False,
                                  decryption_error=None,
                                  best_score=best_score, best_key=desc)
                return frame_data
            frame_data["decrypted"] = True
            frame_data["decrypted_payload"] = "".join(
                map(_BYTE_BITS.__getitem__, plain))
            frame_data["decrypted_bytes"] = plain.hex()
            frame_data["key_used"] = desc
            frame_data["decrypt_confidence"] = best_score
            for alg_name in ("TEA1", "TEA2", "TEA3", "TEA4"):
                if alg_name in desc:
                    frame_data["encryption_algorithm"] = alg_name
                    break
            self.protocol_parser.stats["decrypted_frames"] += 1
        else:
            frame_data["decrypted"] = False
            frame_data["decryption_error"] = (
                f"Tried {n_keys} key(s), best score: {best_score}")
            frame_data["best_score"] = best_score
        return frame_data

    def _decrypt_frame(self, frame_data: dict) -> dict:
        """Aggressive multi-key bruteforce with plaintext scoring
        (decoder.py:576-833).  Host path: per-key TEA on CPU; the batched
        pipeline instead precomputes every plaintext on device
        (crypto.batch.batch_decrypt_frames) and shares _select_decrypt."""
        plan = self._build_key_plan(frame_data)
        if plan is None:
            return frame_data
        payload_bytes, keys_to_try = plan
        return self._select_decrypt(frame_data, payload_bytes, keys_to_try)
