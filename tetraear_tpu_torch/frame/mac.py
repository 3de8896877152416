"""MAC layer: PDU parsing, fragmentation reassembly, call metadata.

Behavioural equivalent of the reference MAC layer
(tetraear/core/protocol.py:349-784).  PDU type/encryption-mode bit layout,
fragment-buffer semantics, SYSINFO MCC/MNC validation and the heuristic call
metadata extraction all follow the reference so that downstream consumers see
identical frame dictionaries.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum

import numpy as np

from tetraear_tpu_torch.frame import burst as burst_mod
from tetraear_tpu_torch.frame import sds as sds_mod

logger = logging.getLogger(__name__)


class PDUType(Enum):
    MAC_RESOURCE = 0
    MAC_FRAG = 1
    MAC_END = 2
    MAC_BROADCAST = 3
    MAC_SUPPL = 4
    MAC_U_SIGNAL = 5
    MAC_DATA = 6
    MAC_U_BLK = 7


@dataclass
class MacPDU:
    pdu_type: PDUType
    encrypted: bool
    address: int | None
    length: int
    data: bytes
    fill_bits: int = 0
    encryption_mode: int = 0      # 0=Clear, 1=Class2(SCK), 2=Class3(DCK)
    reassembled_data: bytes | None = None


@dataclass
class CallMetadata:
    call_type: str
    talkgroup_id: int | None
    source_ssi: int | None
    dest_ssi: int | None
    channel_allocated: int | None
    call_identifier: int | None = None
    call_priority: int = 0
    mcc: int | None = None
    mnc: int | None = None
    duplex_mode: str = "simplex"
    encryption_enabled: bool = False
    encryption_algorithm: str | None = None


@dataclass
class MacFields:
    """Pure (stateless) field extraction of one downlink MAC PDU — the
    part of parse_mac_pdu with no parser state.  Produced either by
    extract_mac_fields (NumPy) or by the native batch engine
    (frame/csrc/hitparse.cpp via frame.hitparse); consumed by
    MacParser.apply_mac_fields."""
    pdu_type_int: int
    enc_mode: int
    fill_bit: int
    address: int | None
    length: int
    data_bytes: bytes
    sysinfo: tuple | None = None    # (mcc, mnc, cc) on SYSINFO broadcast


def extract_mac_fields(bits: np.ndarray) -> MacFields | None:
    """Stateless field extraction (reference protocol.py:349-596; the
    stateful tail lives in MacParser.apply_mac_fields)."""
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 8:
        return None
    pdu_type_int = (int(bits[0]) << 1) | int(bits[1])
    enc_mode = (int(bits[2]) << 1) | int(bits[3])
    address: int | None = None
    length = 0
    data_bytes = b""
    fill_bit = 0
    sysinfo: tuple | None = None

    if pdu_type_int == 0:                       # MAC-RESOURCE
        fill_bit = int(bits[4])
        pos = 5
        if len(bits) < pos + 24:
            return None
        address = burst_mod.bits_to_uint(bits[pos:pos + 24])
        pos += 24
        if len(bits) < pos + 6:
            return None
        length = burst_mod.bits_to_uint(bits[pos:pos + 6])
        pos += 6
        data_len_bits = length * 8
        if data_len_bits > len(bits) - pos + 16:
            return None
        if 0 < data_len_bits <= len(bits) - pos:
            data_bits = bits[pos:pos + data_len_bits]
        else:
            data_bits = bits[pos:]
        data_bytes = burst_mod.bits_to_bytes(data_bits)
    elif pdu_type_int == 1:                     # MAC-FRAG
        fill_bit = int(bits[4])
        data_bytes = burst_mod.bits_to_bytes(bits[5:])
    elif pdu_type_int == 2:                     # MAC-BROADCAST
        broadcast_type = enc_mode               # reuses bits 2..3
        pos = 4
        if broadcast_type == 0:  # SYSINFO: MCC(10) MNC(14) CC(6)
            if len(bits) < pos + 30:
                return None
            mcc = burst_mod.bits_to_uint(bits[pos:pos + 10])
            mnc = burst_mod.bits_to_uint(bits[pos + 10:pos + 24])
            cc = burst_mod.bits_to_uint(bits[pos + 24:pos + 30])
            # ITU-T E.212 sanity gate (protocol.py:487-495)
            if mcc < 200 or mcc > 799:
                return None
            if mnc > 999:
                return None
            sysinfo = (mcc, mnc, cc)
        data_bytes = burst_mod.bits_to_bytes(bits[pos:])
    else:                                       # MAC-END / fallback
        fill_bit = int(bits[4])
        pos = 5
        if len(bits) < pos + 6:
            return None
        length = burst_mod.bits_to_uint(bits[pos:pos + 6])
        pos += 6
        data_len_bits = length * 8
        if data_len_bits > len(bits) - pos + 16:
            return None
        if 0 < data_len_bits <= len(bits) - pos:
            data_bits = bits[pos:pos + data_len_bits]
        else:
            data_bits = bits[pos:]
        data_bytes = burst_mod.bits_to_bytes(data_bits)

    return MacFields(pdu_type_int=pdu_type_int, enc_mode=enc_mode,
                     fill_bit=fill_bit, address=address, length=length,
                     data_bytes=data_bytes, sysinfo=sysinfo)


def new_stats() -> dict:
    return {
        "total_bursts": 0,
        "crc_pass": 0,
        "crc_fail": 0,
        "clear_mode_frames": 0,
        "encrypted_frames": 0,
        "decrypted_frames": 0,
        "voice_calls": 0,
        "data_messages": 0,
        "control_messages": 0,
    }


class MacParser:
    """Stateful MAC parser: carries network identity + fragment buffer."""

    def __init__(self):
        self.mcc: int | None = None
        self.mnc: int | None = None
        self.la: int | None = None
        self.colour_code: int | None = None
        self.stats = new_stats()
        self.fragment_buffer = bytearray()
        self.fragment_metadata: dict = {}

    # -- MAC PDU ----------------------------------------------------------

    def parse_mac_pdu(self, bits: np.ndarray) -> MacPDU | None:
        """Downlink MAC PDU: type(2) + enc-mode(2) header, then per-type
        fields (reference: protocol.py:349-596).

        Split into a PURE field extraction (extract_mac_fields — also
        implemented by the native batch engine, frame/csrc/hitparse.cpp)
        and the STATEFUL application (apply_mac_fields: fragment buffer,
        SYSINFO network identity, stats)."""
        fields = extract_mac_fields(bits)
        if fields is None:
            return None
        return self.apply_mac_fields(fields)

    def apply_mac_fields(self, f: "MacFields") -> MacPDU:
        """Stateful tail of parse_mac_pdu on pre-extracted fields (from
        extract_mac_fields or the hitparse batch engine).  replay_mac_fields
        below replays this state machine from a summary of the fields."""
        pdu_type = {
            0: PDUType.MAC_RESOURCE,
            1: PDUType.MAC_FRAG,
            2: PDUType.MAC_BROADCAST,
        }.get(f.pdu_type_int, PDUType.MAC_END)
        enc_mode = f.enc_mode
        encrypted = enc_mode > 0
        address = f.address
        data_bytes = f.data_bytes

        if pdu_type == PDUType.MAC_RESOURCE:
            # Start a fragmentation chain.
            self.fragment_buffer = bytearray(data_bytes)
            self.fragment_metadata = {
                "address": address, "encrypted": encrypted, "mode": enc_mode,
            }
        elif pdu_type == PDUType.MAC_FRAG:
            self.fragment_buffer.extend(data_bytes)
            if self.fragment_metadata:
                encrypted = self.fragment_metadata.get("encrypted", False)
                address = self.fragment_metadata.get("address")
        elif pdu_type == PDUType.MAC_BROADCAST:
            if f.sysinfo is not None:
                self.mcc, self.mnc, self.colour_code = f.sysinfo
                logger.info("Valid TETRA SYNC: MCC=%s MNC=%s",
                            self.mcc, self.mnc)
        else:  # MAC_END / fallback
            self.fragment_buffer.extend(data_bytes)
            if self.fragment_metadata:
                encrypted = self.fragment_metadata.get("encrypted", False)
                address = self.fragment_metadata.get("address")

        self.stats["encrypted_frames" if encrypted
                   else "clear_mode_frames"] += 1

        pdu = MacPDU(
            pdu_type=pdu_type,
            encrypted=encrypted,
            address=address,
            length=f.length,
            data=data_bytes,
            fill_bits=f.fill_bit,
            encryption_mode=enc_mode,
        )

        if pdu_type == PDUType.MAC_END:
            if self.fragment_buffer:
                pdu.reassembled_data = bytes(self.fragment_buffer)
                if self.fragment_metadata:
                    if not pdu.address:
                        pdu.address = self.fragment_metadata.get("address")
                    pdu.encrypted = self.fragment_metadata.get(
                        "encrypted", False)
                self.fragment_buffer = bytearray()
                self.fragment_metadata = {}
        elif pdu_type == PDUType.MAC_RESOURCE:
            # Single-slot messages: expose current data as reassembled too.
            pdu.reassembled_data = bytes(data_bytes)

        return pdu

    @staticmethod
    def buffer_keeps(types: np.ndarray) -> tuple:
        """Of rows of PDUs that apply_mac_fields applies in turn
        (``types``: (rows, n) pdu_type_int, -1 where there is no PDU):
        whose data the fragment buffer holds after each row (its last
        RESOURCE when no END follows it, and the FRAGs after its last
        RESOURCE or END), and the column of that last RESOURCE or END
        (-1: none).  Holds for PDUs that all have data, as every PDU of
        8 bytes or more has: each END then clears the buffer it
        extends."""
        chain = (types == 0) | (types == 3)
        col = np.arange(types.shape[1])
        at = np.where(chain.any(axis=1),
                      col[-1] - np.argmax(chain[:, ::-1], axis=1), -1)
        kept = (((types == 0) & (col == at[:, None]))
                | ((types == 1) & (col > at[:, None])))
        return kept, at

    def replay_mac_fields(self, pdus: list, last: int, fields_at) -> None:
        """Leave the parser as apply_mac_fields of a row of PDUs in turn
        leaves it, from each one's (pdu_type_int, enc_mode, sysinfo)
        alone (None: no PDU): the encrypted / clear counts, the network
        identity, the fragment buffer and its metadata.  ``last`` is
        buffer_keeps' column for the row; ``fields_at(j)`` gives PDU j's
        MacFields and is asked only for the PDUs buffer_keeps marks,
        which are applied in full.  The same state machine as
        apply_mac_fields: a change to one is a change to both."""
        meta = self.fragment_metadata
        # the chain's encrypted flag while metadata is set, else None
        chain = bool(meta.get("encrypted", False)) if meta else None
        n_enc = n_clear = 0
        for j, pdu in enumerate(pdus):
            if pdu is None:
                continue
            t, e, sysinfo = pdu
            if (t == 0 and j == last) or (t == 1 and j > last):
                # the chain the buffer keeps opens here, or a fragment
                # it keeps
                self.apply_mac_fields(fields_at(j))
                if t == 0:
                    chain = e > 0
                continue
            if t == 0:                          # MAC-RESOURCE
                encrypted = chain = e > 0
            elif t == 2:                        # MAC-BROADCAST
                encrypted = e > 0
                if sysinfo is not None:
                    self.mcc, self.mnc, self.colour_code = sysinfo
                    logger.info("Valid TETRA SYNC: MCC=%s MNC=%s",
                                self.mcc, self.mnc)
            else:                               # MAC-FRAG, MAC-END
                encrypted = chain if chain is not None else e > 0
                if t == 3:
                    chain = None
                    if j == last:
                        self.fragment_buffer = bytearray()
                        self.fragment_metadata = {}
            if encrypted:
                n_enc += 1
            else:
                n_clear += 1
        self.stats["encrypted_frames"] += n_enc
        self.stats["clear_mode_frames"] += n_clear

    # -- Call metadata ----------------------------------------------------

    def parse_call_metadata(self, pdu: MacPDU) -> CallMetadata | None:
        """Heuristic metadata extraction (protocol.py:597-725)."""
        if not pdu or len(pdu.data) < 4:
            return None
        if pdu.pdu_type == PDUType.MAC_RESOURCE:
            return self._parse_resource_assignment(pdu)
        if pdu.pdu_type == PDUType.MAC_U_SIGNAL:
            return self._parse_call_setup(pdu)
        if pdu.pdu_type == PDUType.MAC_BROADCAST:
            return self._parse_broadcast(pdu)
        return None

    def _parse_resource_assignment(self, pdu: MacPDU) -> CallMetadata | None:
        data = pdu.data
        if len(data) < 8:
            return None
        call_type = "Group" if data[0] & 0x80 else "Individual"
        talkgroup = int.from_bytes(data[1:4], "big") & 0xFFFFFF
        channel = data[4] & 0x3F
        enc_on = bool(data[5] & 0x80)
        priority = (data[5] >> 2) & 0x0F
        call_id = ((data[6] & 0x0F) << 10) | (data[7] << 2)
        source_ssi = None
        if len(data) > 10:
            for i in range(8, len(data) - 3):
                val = int.from_bytes(data[i:i + 3], "big") & 0xFFFFFF
                if (val != talkgroup and 1000 < val < 16_000_000
                        and val not in (0, 0xFFFFFF)):
                    source_ssi = val
                    break
        self.stats["control_messages"] += 1
        return CallMetadata(
            call_type=call_type, talkgroup_id=talkgroup,
            source_ssi=source_ssi, dest_ssi=None, channel_allocated=channel,
            call_identifier=call_id, call_priority=priority,
            mcc=self.mcc, mnc=self.mnc, encryption_enabled=enc_on,
            encryption_algorithm="TEA1" if enc_on else None,
        )

    def _parse_call_setup(self, pdu: MacPDU) -> CallMetadata | None:
        data = pdu.data
        if len(data) < 12:
            return None
        source_ssi = int.from_bytes(data[0:3], "big") & 0xFFFFFF
        dest_ssi = int.from_bytes(data[3:6], "big") & 0xFFFFFF
        if data[6] & 0x80:
            call_type = "Voice"
            self.stats["voice_calls"] += 1
        else:
            call_type = "Data"
            self.stats["data_messages"] += 1
        enc_on = bool(data[7] & 0x80)
        enc_alg = None
        if enc_on:
            enc_alg = {1: "TEA1", 2: "TEA2", 3: "TEA3", 4: "TEA4"}.get(
                (data[7] >> 4) & 0x07)
        return CallMetadata(
            call_type=call_type,
            talkgroup_id=dest_ssi if call_type == "Voice" else None,
            source_ssi=source_ssi, dest_ssi=dest_ssi, channel_allocated=None,
            mcc=self.mcc, mnc=self.mnc, encryption_enabled=enc_on,
            encryption_algorithm=enc_alg,
        )

    def _parse_broadcast(self, pdu: MacPDU) -> CallMetadata | None:
        data = pdu.data
        if len(data) < 5:
            return None
        bits = burst_mod.bytes_to_bits(data)
        mcc = burst_mod.bits_to_uint(bits[0:10])
        mnc = burst_mod.bits_to_uint(bits[10:24])
        cc = burst_mod.bits_to_uint(bits[24:30])
        if mcc < 200 or mcc > 799 or mnc > 999:
            return None
        self.mcc, self.mnc, self.colour_code = mcc, mnc, cc
        return CallMetadata(
            call_type="Broadcast", talkgroup_id=None, source_ssi=None,
            dest_ssi=None, channel_allocated=None, mcc=mcc, mnc=mnc,
            encryption_enabled=False,
        )

    # -- SDS / voice ------------------------------------------------------

    def parse_sds_message(self, pdu: MacPDU) -> str | None:
        if pdu.pdu_type not in (PDUType.MAC_DATA, PDUType.MAC_SUPPL):
            return None
        return self.parse_sds_data(pdu.data)

    def parse_sds_data(self, data: bytes) -> str | None:
        return sds_mod.parse_sds_data(data, stats=self.stats)

    def extract_voice_payload(self, pdu: MacPDU) -> bytes | None:
        return pdu.data or None

    # -- Stats ------------------------------------------------------------

    def get_statistics(self) -> dict:
        total = (self.stats["clear_mode_frames"]
                 + self.stats["encrypted_frames"])
        clear_pct = (self.stats["clear_mode_frames"] / total * 100
                     if total else 0)
        enc_pct = (self.stats["encrypted_frames"] / total * 100
                   if total else 0)
        return {
            **self.stats,
            "clear_mode_percentage": clear_pct,
            "encrypted_percentage": enc_pct,
            "crc_success_rate": (self.stats["crc_pass"]
                                 / max(1, self.stats["total_bursts"])) * 100,
        }
