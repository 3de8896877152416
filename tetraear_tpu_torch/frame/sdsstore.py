"""SDS message store: the data model behind the GUI's SDS tab.

Framework-level equivalent of the reference's SDS reassembly view
(tetraear/ui/modern.py:4196-4324): collects SDS-bearing frames into a
per-sender conversation list, tracking fragment reassembly state,
repeat suppression and message history — Qt-free so the CLI, dashboard
and Qt GUI all consume the same store (like frame.aggregator).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class SDSMessage:
    text: str
    source_ssi: int | None
    talkgroup: int | None
    carrier: int
    frequency: float | None
    reassembled: bool
    decrypted: bool
    first_seen: float
    last_seen: float
    repeats: int = 1


@dataclass
class SDSMessageStore:
    """Collects decoded SDS texts with repeat suppression."""

    max_messages: int = 500
    repeat_window_s: float = 30.0
    messages: list = field(default_factory=list)

    def add_frame(self, frame: dict, now: float | None = None) -> \
            SDSMessage | None:
        """Feed a decoded frame; returns the (new or refreshed) message
        when the frame carried readable SDS text, else None."""
        text = frame.get("sds_message") or frame.get("decoded_text")
        if not text or str(text).startswith("[BIN"):
            return None
        now = now if now is not None else time.time()
        meta = frame.get("call_metadata") or {}
        ssi = meta.get("source_ssi")
        tg = meta.get("talkgroup_id")

        # repeat suppression: same text from the same sender within the
        # window bumps the counter instead of duplicating the row
        for m in reversed(self.messages):
            if now - m.last_seen > self.repeat_window_s:
                break
            if m.text == text and m.source_ssi == ssi \
                    and m.talkgroup == tg:
                m.repeats += 1
                m.last_seen = now
                m.reassembled |= bool(frame.get("is_reassembled"))
                m.decrypted |= bool(frame.get("decrypted"))
                return m

        msg = SDSMessage(
            text=str(text), source_ssi=ssi, talkgroup=tg,
            carrier=int(frame.get("carrier", 0)),
            frequency=frame.get("frequency"),
            reassembled=bool(frame.get("is_reassembled")),
            decrypted=bool(frame.get("decrypted")),
            first_seen=now, last_seen=now)
        self.messages.append(msg)
        if len(self.messages) > self.max_messages:
            del self.messages[:len(self.messages) - self.max_messages]
        return msg

    def by_sender(self) -> dict:
        """{source_ssi (or 'unknown'): [messages]} for conversation view."""
        out: dict = {}
        for m in self.messages:
            out.setdefault(m.source_ssi
                           if m.source_ssi is not None else "unknown",
                           []).append(m)
        return out

    def snapshot(self) -> list:
        """Rows for table display, newest last."""
        return [{
            "time": m.last_seen,
            "source": m.source_ssi if m.source_ssi is not None else "",
            "talkgroup": m.talkgroup if m.talkgroup is not None else "",
            "carrier": m.carrier,
            "flags": "".join(["R" if m.reassembled else "",
                              "D" if m.decrypted else "",
                              f"x{m.repeats}" if m.repeats > 1 else ""]),
            "text": m.text,
        } for m in self.messages]
