"""Frames-table filtering model (Qt-free).

Equivalent of the reference's filter dropdowns + readability filtering
(tetraear/ui/modern.py:4326-4473, 4784-5075): frame-type, encryption
and readability predicates that decide which decoded frames reach the
display, shared by the Qt frames table and the CLI listener.
"""

from __future__ import annotations

TYPE_CHOICES = ("All types", "MAC-RESOURCE", "MAC-FRAG", "MAC-BROADCAST",
                "MAC-END/RES")
ENC_CHOICES = ("All", "Clear only", "Encrypted only", "Decrypted only")
READ_CHOICES = ("All frames", "Readable only", "CRC-pass only")


def is_readable(frame: dict) -> bool:
    """The reference's readability gate (modern.py:4784-5075): a frame
    is worth showing when it carries decoded text, call metadata, a
    successful decrypt, or a CRC-validated burst."""
    if frame.get("sds_message") and not str(
            frame["sds_message"]).startswith("[BIN"):
        return True
    meta = frame.get("call_metadata") or {}
    if meta.get("talkgroup_id") or meta.get("source_ssi") or \
            meta.get("mcc"):
        return True
    if frame.get("decrypted"):
        return True
    return bool(frame.get("burst_crc"))


class FrameFilter:
    """Composable display filter driven by the three dropdown values."""

    def __init__(self, type_choice: str = TYPE_CHOICES[0],
                 enc_choice: str = ENC_CHOICES[0],
                 read_choice: str = READ_CHOICES[0]):
        self.type_choice = type_choice
        self.enc_choice = enc_choice
        self.read_choice = read_choice

    def accepts(self, frame: dict) -> bool:
        if self.type_choice != "All types":
            if str(frame.get("type_name", "")) != self.type_choice:
                return False
        if self.enc_choice == "Clear only":
            if frame.get("encrypted") and not frame.get("decrypted"):
                return False
        elif self.enc_choice == "Encrypted only":
            if not frame.get("encrypted"):
                return False
        elif self.enc_choice == "Decrypted only":
            if not frame.get("decrypted"):
                return False
        if self.read_choice == "Readable only" and not is_readable(frame):
            return False
        if self.read_choice == "CRC-pass only" and \
                not frame.get("burst_crc"):
            return False
        return True

    def filter(self, frames: list) -> list:
        return [f for f in frames if self.accepts(f)]
