"""TDMA frame-hierarchy containers and tracking.

Equivalent of the reference's slot/frame/multiframe/hyperframe dataclasses
(tetraear/core/protocol.py:79-110) plus a tracker that places decoded
bursts into the TDMA hierarchy: 4 slots/frame, 18 frames/multiframe
(1.02 s), 60 multiframes/hyperframe (61.2 s).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tetraear_tpu_torch.frame.burst import (ChannelType, FRAMES_PER_MULTIFRAME,
                                      MULTIFRAMES_PER_HYPERFRAME,
                                      SLOTS_PER_FRAME, TetraBurst)


@dataclass
class TetraSlot:
    """One time slot: 255 symbols = 14.167 ms."""
    slot_number: int
    frame_number: int
    burst: TetraBurst | None
    channel_type: ChannelType = ChannelType.SCH
    encrypted: bool = False
    encryption_mode: int = 0


@dataclass
class TetraFrame:
    """4 slots = 56.67 ms."""
    frame_number: int
    slots: list = field(default_factory=list)
    multiframe_number: int = 0


@dataclass
class TetraMultiframe:
    """18 frames = 1.02 s; frame 18 is the control frame."""
    multiframe_number: int
    frames: list = field(default_factory=list)


@dataclass
class TetraHyperframe:
    """60 multiframes = 61.2 s."""
    hyperframe_number: int
    multiframes: list = field(default_factory=list)


class FrameStructureTracker:
    """Assign a running slot counter to the TDMA hierarchy and keep
    occupancy statistics per slot position (which slots carry traffic vs
    control — the input to channel-allocation views)."""

    def __init__(self):
        self.slot_counter = 0
        self.slot_occupancy = [0] * SLOTS_PER_FRAME
        self.crc_by_slot = [0] * SLOTS_PER_FRAME
        self.current_multiframe = 0
        self.current_hyperframe = 0

    def place(self, burst: TetraBurst | None = None) -> TetraSlot:
        """Register the next slot; returns its hierarchy coordinates."""
        idx = self.slot_counter
        self.slot_counter += 1
        slot_number = idx % SLOTS_PER_FRAME
        frame_number = (idx // SLOTS_PER_FRAME) % FRAMES_PER_MULTIFRAME
        self.current_multiframe = (
            idx // (SLOTS_PER_FRAME * FRAMES_PER_MULTIFRAME)
        ) % MULTIFRAMES_PER_HYPERFRAME
        self.current_hyperframe = idx // (
            SLOTS_PER_FRAME * FRAMES_PER_MULTIFRAME
            * MULTIFRAMES_PER_HYPERFRAME)
        if burst is not None:
            self.slot_occupancy[slot_number] += 1
            if burst.crc_ok:
                self.crc_by_slot[slot_number] += 1
        return TetraSlot(slot_number=slot_number, frame_number=frame_number,
                         burst=burst)

    def place_at(self, slot_index: int,
                 crc_ok: bool | None = None) -> TetraSlot:
        """Place an observed burst at an absolute slot index.

        The streaming pipeline derives the index from the frame's global
        symbol position (255 symbols/slot), so unobserved slots between
        sync hits are skipped rather than miscounted.
        """
        slot_number = slot_index % SLOTS_PER_FRAME
        frame_number = (slot_index // SLOTS_PER_FRAME) % FRAMES_PER_MULTIFRAME
        self.current_multiframe = (
            slot_index // (SLOTS_PER_FRAME * FRAMES_PER_MULTIFRAME)
        ) % MULTIFRAMES_PER_HYPERFRAME
        self.current_hyperframe = slot_index // (
            SLOTS_PER_FRAME * FRAMES_PER_MULTIFRAME
            * MULTIFRAMES_PER_HYPERFRAME)
        self.slot_counter = max(self.slot_counter, slot_index + 1)
        if crc_ok is not None:
            self.slot_occupancy[slot_number] += 1
            if crc_ok:
                self.crc_by_slot[slot_number] += 1
        return TetraSlot(slot_number=slot_number, frame_number=frame_number,
                         burst=None)

    def stats(self) -> dict:
        return {
            "slots_seen": self.slot_counter,
            "multiframe": self.current_multiframe,
            "hyperframe": self.current_hyperframe,
            "occupancy_by_slot": list(self.slot_occupancy),
            "crc_by_slot": list(self.crc_by_slot),
        }
