"""The tracer's spans and counters on the classic chain and the detection
gate (runtime/profiling.py; dsp/pipeline.CarrierBankDemod._step_impl,
runtime/stream.DecodeRunner._block_classic, api.Pipeline._process_block).

A small `cli listen` geometry on the CPU: 2.4 Msps, the conv front end,
per-carrier AFC and the detection gate on, four carriers (clear SDS, TEA
under a common key of each family, voice), three blocks:

  * ``frontend``, ``timing`` and ``scan`` open once a block inside
    ``step``, ``gate`` once a block inside ``block``;
  * the ``gated`` counter takes an all-zero block the gate drops, and
    such a block opens no ``step``;
  * the frames are the same traced and untraced.

The fused chain's span set is held in tests/test_torch_tracing.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu_torch import golden  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.frame.decoder import TetraDecoder  # noqa: E402
from tetraear_tpu_torch.runtime import profiling as prof  # noqa: E402

FS = 2.4e6
FOUR = [(i - 2) * 25_000 + 12_500.0 for i in range(4)]
BLOCK = 64_000                     # 480 symbols, a multiple of 400
N_BLOCKS = 3
STAGES = ("frontend", "timing", "scan")
KEY_FIELDS = ("carrier", "stream_symbol", "position", "burst_crc", "type",
              "sds_message", "encrypted", "decrypted", "key_used",
              "decrypted_bytes", "has_voice")


@pytest.fixture
def tr():
    """The process's tracer, emptied, switched off again afterwards."""
    t = prof.tracer()
    t.enable(False)
    t.reset()
    yield t
    t.enable(False)
    t.reset()


def _pipe(frames=None) -> Pipeline:
    cfg = PipelineConfig(sample_rate=FS, carrier_offsets_hz=tuple(FOUR),
                         block_len=BLOCK, frontend="conv", carrier_afc=True,
                         detect_gate=True, loss_hysteresis_s=0.0,
                         device="cpu")
    return Pipeline(cfg, on_frame=None if frames is None else frames.append)


@pytest.fixture(scope="module")
def capture():
    common = TetraDecoder().common_keys
    iq, _ = golden.fleet_capture(
        FS, FOUR, [0], N_BLOCKS * BLOCK, seed=11,
        encrypted={1: ("TEA1", common["TEA1"][0]),
                   2: ("TEA2", common["TEA2"][0])},
        voice={3: 0})
    return iq


def _run(iq) -> list:
    frames = []
    pipe = _pipe(frames)
    try:
        assert pipe.runner.fused is None           # the classic chain
        for i in range(N_BLOCKS):
            pipe.process_block(iq[i * BLOCK:(i + 1) * BLOCK])
    finally:
        pipe.close()
    return [{k: f.get(k) for k in KEY_FIELDS} for f in frames]


@pytest.fixture(scope="module")
def runs(capture):
    """(untraced frames, traced frames, the traced blocks)."""
    t = prof.tracer()
    t.enable(False)
    t.reset()
    try:
        off = _run(capture)
        t.enable()
        on = _run(capture)
        return off, on, list(t.blocks)
    finally:
        t.enable(False)
        t.reset()


def test_classic_frames_same_traced_and_untraced(runs):
    off, on, _ = runs
    assert off == on
    assert any(f["sds_message"] for f in on)
    assert any(f["decrypted"] for f in on)


def test_classic_stage_spans_inside_step_every_block(runs):
    blocks = runs[2]
    assert len(blocks) == N_BLOCKS
    for rec in blocks:
        names = [s[0] for s in rec.spans]
        parent = {s[0]: rec.spans[s[3]][0] for s in rec.spans[1:]}
        for name in STAGES:
            assert names.count(name) == 1, (name, names)
            assert parent[name] == "step"
        assert names.count("gate") == 1 and parent["gate"] == "block"
        assert names.index("gate") < names.index("step")
        # the stages run in order and lie inside the step
        step = rec.spans[names.index("step")]
        rows = [rec.spans[names.index(n)] for n in STAGES]
        assert step[1] <= rows[0][1]
        for a, b in zip(rows, rows[1:]):
            assert a[2] <= b[1]
        assert rows[-1][2] <= step[2]
        assert "gated" not in rec.counts
        assert not rec.device_ms                 # no CUDA events on the CPU


def test_gate_counts_an_all_zero_block_as_dropped(tr, capture):
    pipe = _pipe()
    tr.enable()
    try:
        assert pipe.process_block(np.zeros(BLOCK, np.complex64)) == []
        pipe.process_block(capture[:BLOCK])
    finally:
        pipe.close()
    dropped, passed = tr.blocks
    assert dropped.counts == {"gated": 1, "launches": 0}
    assert [s[0] for s in dropped.spans] == ["block", "gate"]
    names = [s[0] for s in passed.spans]
    assert "gated" not in passed.counts
    assert names.count("gate") == 1 and "step" in names
    assert tr.counters()["gated"] == 1


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the stages' CUDA events)")


@pytest.mark.cuda
def test_stage_events_read_in_fetch(card, tr, capture):
    """On the card each stage's two CUDA events are read in ``fetch``,
    and the three stages lie inside the step's events."""
    cfg = PipelineConfig(sample_rate=FS, carrier_offsets_hz=tuple(FOUR),
                         block_len=BLOCK, frontend="conv", carrier_afc=True,
                         detect_gate=True, loss_hysteresis_s=0.0,
                         device="cuda", voice=False)
    pipe = Pipeline(cfg)
    tr.enable()
    try:
        for i in range(N_BLOCKS):
            pipe.process_block(capture[i * BLOCK:(i + 1) * BLOCK])
    finally:
        pipe.close()
    for rec in tr.blocks:
        ms = rec.device_ms
        assert set(ms) == {"step", *STAGES}, ms
        assert all(v > 0 for v in ms.values()), ms
        assert sum(ms[n] for n in STAGES) <= ms["step"] * 1.001, ms
