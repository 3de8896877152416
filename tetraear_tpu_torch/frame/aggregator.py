"""Call/group/user aggregation over the decoded frame stream.

Framework-level equivalent of the reference GUI's Calls/Groups/Users
tables (tetraear/ui/modern.py:4474-4656): tracks activity per talkgroup
and subscriber, groups frames into calls with an inactivity timeout, and
serves any front-end (CLI, dashboard, Qt, JSON export).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class CallRecord:
    talkgroup: int | None
    source_ssi: int | None
    call_type: str = "Unknown"
    priority: int = 0
    encrypted: bool = False
    frames: int = 0
    first_seen: float = 0.0
    last_seen: float = 0.0
    has_voice: bool = False

    @property
    def duration_s(self) -> float:
        return max(0.0, self.last_seen - self.first_seen)


@dataclass
class PartyRecord:
    ident: int
    frames: int = 0
    last_seen: float = 0.0
    talkgroups: set = field(default_factory=set)


class CallAggregator:
    """Feed decoded frame dicts; query live calls / groups / users."""

    def __init__(self, call_timeout_s: float = 5.0):
        self.call_timeout_s = call_timeout_s
        self.active_calls: dict = {}       # talkgroup -> CallRecord
        self.finished_calls: list = []
        self.groups: dict = {}             # talkgroup -> PartyRecord
        self.users: dict = {}              # ssi -> PartyRecord

    def add_frame(self, frame: dict, now: float | None = None) -> None:
        now = now if now is not None else time.time()
        meta = frame.get("call_metadata") or {}
        tg = meta.get("talkgroup_id")
        ssi = meta.get("source_ssi")

        if tg:
            g = self.groups.setdefault(tg, PartyRecord(ident=tg))
            g.frames += 1
            g.last_seen = now
            call = self.active_calls.get(tg)
            if call is None:
                call = CallRecord(talkgroup=tg, source_ssi=ssi,
                                  first_seen=now)
                self.active_calls[tg] = call
            call.frames += 1
            call.last_seen = now
            call.encrypted = call.encrypted or bool(frame.get("encrypted"))
            call.has_voice = call.has_voice or bool(frame.get("has_voice"))
            if meta.get("call_type"):
                call.call_type = meta["call_type"]
            if meta.get("priority"):
                call.priority = meta["priority"]
            if ssi and not call.source_ssi:
                call.source_ssi = ssi

        if ssi:
            u = self.users.setdefault(ssi, PartyRecord(ident=ssi))
            u.frames += 1
            u.last_seen = now
            if tg:
                u.talkgroups.add(tg)

        self.poll(now)

    def poll(self, now: float | None = None) -> list:
        """Finalize calls idle past the timeout; returns newly finished."""
        now = now if now is not None else time.time()
        done = []
        for tg in list(self.active_calls):
            call = self.active_calls[tg]
            if now - call.last_seen >= self.call_timeout_s:
                del self.active_calls[tg]
                self.finished_calls.append(call)
                done.append(call)
        return done

    def snapshot(self) -> dict:
        """JSON-friendly view for UIs and logs."""
        return {
            "active_calls": [
                {"talkgroup": c.talkgroup, "source_ssi": c.source_ssi,
                 "type": c.call_type, "frames": c.frames,
                 "duration_s": round(c.duration_s, 2),
                 "encrypted": c.encrypted, "voice": c.has_voice}
                for c in self.active_calls.values()],
            "finished_calls": len(self.finished_calls),
            "groups": [
                {"talkgroup": g.ident, "frames": g.frames}
                for g in sorted(self.groups.values(),
                                key=lambda g: -g.frames)],
            "users": [
                {"ssi": u.ident, "frames": u.frames,
                 "talkgroups": sorted(u.talkgroups)}
                for u in sorted(self.users.values(),
                                key=lambda u: -u.frames)],
        }
