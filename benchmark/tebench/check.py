"""Whether the frames the timed path delivered are right.

The comparison covers a sample of carriers drawn from the seed, of
every kind the mix has (idle ones too), over every block of the judged
span: the window's blocks and the few after it that end the span on a
whole cycle of the capture (``harness.run_cell``).
What each carrier should give is worked out from what it sent (the
``Truth``), by the benchmark's own code: the SDS text the frozen parser
reads from the sent PDU, the auto-decrypt decision of ``keyplan`` on the
sent ciphertext, the sent speech parameters, and their PCM from the
standard's speech decoder (``refpcm``), on the frames the program put on
sent slots.  The program's frames are read
only to be judged, and to align each carrier's symbol count with the
sent slots.

One number is held to the cell's limit, ``failed_share``: the slots
sent inside the judged span on the watched carriers that came back as no
frame (``missed``; a voice slot: no channel-decoded frame) or as a frame
that is wrong (``wrong``), over the slots sent.  A frame is wrong for a
CRC verdict other than the frame decoder's rule gives for the sent
bits, a text or decryption other than the reference's, speech
parameters other than those sent, PCM other than the ETSI decoding of
the sent frames in the order they were synthesized, a slot delivered
twice, a CRC-passing data frame or any voice frame of a watched carrier
on none of its slots, or another carrier's text on an idle one.  A sound program does not read
0: its sync search takes the first sync-like window and skips ahead, so
a sent pattern close to a sync word just before a slot hides that slot
(about one voice slot in 150), and a frame the demodulator gets a bit or
two wrong can still pass the lenient CRC gate (about one in 8,000).
Both sit at fixed positions of the capture's cycle, which is why the
span is whole cycles; ``failed_by_position`` and ``failed_by_cycle``
say where the failures fell.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from tebench import keyplan, refpcm
from tebench.frozen import sds
from tebench.slots import SLOT_SYMS

TOL = 8              # symbols between a frame and its slot
EDGE = 300           # symbols kept clear of the window's two ends


def watched(truth, per_role: int, n_idle: int, seed: int) -> dict:
    """{carrier: role} of the carriers the comparison reads."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
    by_role = defaultdict(list)
    for ci, car in sorted(truth.carriers.items()):
        by_role[car.role].append(ci)
    out = {}
    for role, cis in by_role.items():
        pick = rng.choice(cis, min(per_role, len(cis)), replace=False)
        out.update({int(c): role for c in pick})
    idle = sorted(set(range(truth.n_carriers)) - set(truth.carriers))
    if idle:
        for c in rng.choice(idle, min(n_idle, len(idle)), replace=False):
            out[int(c)] = "idle"
    return out


def _lattice(truth, car) -> np.ndarray:
    """Slot starts of one cycle, in sent symbols."""
    return car.lead + SLOT_SYMS * np.arange(truth.n_slots)


def _align(truth, car, syms: list) -> tuple:
    """(offset of the receiver's symbol count against the sent symbols,
    {frame symbol: (cycle, slot) or None}) from a carrier's frame
    positions: the offset is the commonest residue against the slot
    lattice."""
    if not syms:
        return 0, {}
    ns = truth.cycle_syms
    lat = _lattice(truth, car)
    res = []
    for s in syms:
        r = (s - car.lead) % ns
        res.append(int((r + SLOT_SYMS // 2) % SLOT_SYMS - SLOT_SYMS // 2))
    off = Counter(res).most_common(1)[0][0]
    where = {}
    for s in syms:
        t = s - off
        cyc, pos = divmod(t, ns)
        j = int(np.argmin(np.abs(lat - pos)))
        if abs(int(lat[j]) - pos) <= TOL:
            where[s] = (int(cyc), j)
        elif pos < lat[0] and abs(int(lat[-1]) - ns - pos) <= TOL:
            where[s] = (int(cyc) - 1, truth.n_slots - 1)
        else:
            where[s] = None
    return off, where


def _expected_slots(truth, car, off: int, b0: int, b1: int) -> set:
    """(cycle, slot) of the slots whose start lies inside the window,
    EDGE symbols clear of both ends, in receiver symbols."""
    lo = b0 * truth.block_syms + EDGE
    hi = (b1 + 1) * truth.block_syms - EDGE - SLOT_SYMS
    ns = truth.cycle_syms
    lat = _lattice(truth, car)
    out = set()
    for cyc in range((lo - off) // ns - 1, (hi - off) // ns + 2):
        for j, p in enumerate(lat):
            s = cyc * ns + int(p) + off
            if lo <= s <= hi:
                out.add((cyc, j))
    return out


def compare(truth, watch: dict, frames: list, voice: list, b0: int, b1: int,
            control: bool = False) -> dict:
    """Judge the recorded frames of the watched carriers.

    frames: (block, carrier, symbol, crc, sds_message, encrypted,
    decrypted, decrypted_bytes) of every frame of a watched carrier;
    voice: (block, carrier, symbol, params (2, 138), audio) of every
    channel-decoded voice frame of one, in the order they were
    synthesized.  Blocks b0..b1 are the judged span.  ``control``: judge, in
    place of the program's frames, the reference's own answers without
    the slots that cross a block boundary (a receiver that carries no
    state from block to block)."""
    ns = truth.cycle_syms
    texts = {}
    for ci, car in truth.carriers.items():
        if car.role == "sds":
            texts[sds.parse_sds_data(car.payload)] = ci
    want = {}
    for ci, role in watch.items():
        car = truth.carriers.get(ci)
        if role == "sds":
            want[ci] = ("sds", sds.parse_sds_data(car.payload))
        elif role in ("tea_common", "tea_unknown"):
            want[ci] = ("tea", keyplan.decision(car.payload, car.family))
    by_c = defaultdict(list)
    for rec in frames:
        by_c[rec[1]].append(rec)
    v_by_c = defaultdict(list)
    for rec in voice:
        v_by_c[rec[1]].append(rec)
    missed = wrong = expected = judged = 0
    details = Counter()
    examples = []
    at = []                # (symbol, block or None) of each failure
    for ci, role in sorted(watch.items()):
        car = truth.carriers.get(ci)
        if role == "idle":
            for rec in by_c[ci]:
                if b0 <= rec[0] <= b1 and rec[3] and rec[4] in texts:
                    wrong += 1
                    details["idle_text"] += 1
                    at.append((rec[2], rec[0]))
            continue
        recs = v_by_c[ci] if role == "voice" else by_c[ci]
        off, where = _align(truth, car, [r[2] for r in recs])
        lat = _lattice(truth, car)
        exp = _expected_slots(truth, car, off, b0, b1)
        if control:
            recs, where = _control_frames(truth, car, off, exp, role, want)
        expected += len(exp)
        seen = Counter()
        pcm = (_reference_pcm(truth, car, recs, where) if role == "voice"
               else None)
        for k, rec in enumerate(recs):
            slot = where.get(rec[2])
            if slot is not None:
                seen[slot] += 1
            if not b0 <= rec[0] <= b1:
                continue
            judged += 1
            if slot is None:
                # a frame where the sync search found a sync word in sent
                # bits that are no slot's: a data frame is the decoder's
                # own semantics unless it passes the CRC; a voice frame is
                # speech that nobody sent
                if role == "voice":
                    wrong += 1
                    details["voice_off_slot"] += 1
                    at.append((rec[2], rec[0]))
                elif rec[3]:
                    wrong += 1
                    details["crc_off_slot"] += 1
                    at.append((rec[2], rec[0]))
                else:
                    details["spurious"] += 1
                continue
            start = slot[0] * ns + int(lat[slot[1]]) + off
            if seen[slot] == 2:
                wrong += 1
                details["twice"] += 1
                at.append((start, rec[0]))
            if role == "voice":
                bad = _judge_voice(car, slot, rec, pcm[k])
            elif rec[3] != bool(car.crc_ok[slot[1]]):
                bad = "crc"
            elif rec[3]:
                bad = _judge_data(want[ci], rec)
            else:
                bad = None
            if bad:
                wrong += 1
                details[bad] += 1
                at.append((start, rec[0]))
                examples.append((bad, ci, role, slot) + (
                    () if role == "voice" else tuple(rec[3:])))
        gone = [s for s in exp if s not in seen]
        missed += len(gone)
        at.extend((cyc * ns + int(lat[j]) + off, None) for cyc, j in gone)
        if gone:
            details["missed_" + role] += len(gone)
            for cyc, j in sorted(gone)[:2]:
                tx = cyc * truth.cycle_syms + int(_lattice(truth, car)[j])
                near = [(r[0], r[2] - off - tx) for r in by_c[ci]
                        if abs(r[2] - off - tx) < SLOT_SYMS]
                examples.append((ci, role, cyc, j,
                                 tx // truth.block_syms,
                                 tx % truth.block_syms, near))
    by_pos, by_cyc = _where_failed(truth, at, b0, b1)
    return {"missed": missed, "wrong": wrong, "expected": expected,
            "judged": judged,
            "failed_share": (missed + wrong) / expected if expected else 1.0,
            "failed_by_position": by_pos, "failed_by_cycle": by_cyc,
            "details": dict(details), "examples": examples[:12]}


def _where_failed(truth, at: list, b0: int, b1: int) -> tuple:
    """(failures by the capture block their slot starts in, by judged
    cycle) of ``at``: (receiver symbol of the slot's start, or of an
    off-slot frame; the block that delivered a wrong frame, None for a
    missed slot).  The span b0..b1 holds ``k`` cycles, as the judge
    does: a wrong frame counts in the cycle of the block that delivered
    it (cycle c: blocks b0 + c x cycle_blocks on), a missed slot in the
    cycle of its start, counted back from the span's last judged start
    (cycle c: the starts ``k - 1 - c`` cycles before it, or fewer).  So
    every cycle but the first is whole, and the first lacks the slots
    in the span's two edges (``EDGE``).  Outside the span a count goes
    to the nearest cycle."""
    bs, cb, ns = truth.block_syms, truth.cycle_blocks, truth.cycle_syms
    k = max(1, -(-(b1 - b0 + 1) // cb))
    hi = (b1 + 1) * bs - EDGE - SLOT_SYMS
    by_pos, by_cyc = [0] * cb, [0] * k
    for s, blk in at:
        by_pos[(s // bs) % cb] += 1
        c = (blk - b0) // cb if blk is not None else k - 1 - (hi - s) // ns
        by_cyc[min(max(c, 0), k - 1)] += 1
    return by_pos, by_cyc


def _judge_data(want: tuple, rec: tuple) -> str | None:
    kind, w = want
    if kind == "sds":
        return None if rec[4] == w else "text"
    if w["clear"]:
        return None if not rec[5] and not rec[6] else "decrypt"
    if w["decrypted"]:
        ok = bool(rec[6]) and rec[7] == w["plaintext"].hex()
        return None if ok else "decrypt"
    return None if not rec[6] else "decrypt"


def _judge_voice(car, slot: tuple, rec: tuple, ref) -> str | None:
    if rec[3] is None or not np.array_equal(np.asarray(rec[3]),
                                            car.params[slot[1]]):
        return "params"
    got = rec[4]
    if got is None or got.shape != ref.shape or not np.array_equal(got, ref):
        return "pcm"
    return None


def _reference_pcm(truth, car, recs: list, where: dict) -> list:
    """The reference PCM of each voice frame the program synthesized on a
    slot: the parameters sent in those slots, decoded in the program's
    order on one ETSI decoder state.  A frame on no slot is left out of
    that state (its PCM is None: the frame is wrong by itself), so a
    program that feeds one to its decoder reads wrong from there on."""
    on = [k for k, r in enumerate(recs) if where.get(r[2]) is not None]
    out = [None] * len(recs)
    if not on:
        return out
    params = np.concatenate([car.params[where[recs[k][2]][1]]
                             for k in on]).astype(np.int16)
    pcm = refpcm.decode(params).reshape(len(on), 480)
    for k, a in zip(on, pcm):
        a = a.astype(np.float32) / 32768.0
        if float(np.max(np.abs(a))) < 1e-5:
            a = np.zeros(0, np.float32)
        out[k] = a
    return out


def _control_frames(truth, car, off: int, exp: set, role: str,
                    want: dict) -> tuple:
    """The control's frames: every expected slot except those that cross
    a block boundary, with the reference's own content."""
    recs, where = [], {}
    ns = truth.cycle_syms
    bs = truth.block_syms
    lat = _lattice(truth, car)
    for cyc, j in sorted(exp):
        tx = cyc * ns + int(lat[j])
        if tx // bs != (tx + SLOT_SYMS - 1) // bs:
            continue
        s = tx + off
        b = (tx + SLOT_SYMS - 1) // bs
        where[s] = (cyc, j)
        if role == "voice":
            recs.append((b, car.index, s, car.params[j], None))
        else:
            kind, w = want[car.index]
            crc = bool(car.crc_ok[j])
            if kind == "sds":
                recs.append((b, car.index, s, crc, w, False, False, None))
            else:
                dec = w["decrypted"]
                recs.append((b, car.index, s, crc, None, not w["clear"], dec,
                             w["plaintext"].hex() if dec else None))
    if role == "voice":
        pcm = _reference_pcm(truth, car, recs, where)
        recs = [r[:4] + (a,) for r, a in zip(recs, pcm)]
    return recs, where
