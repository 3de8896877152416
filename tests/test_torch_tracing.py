"""The port's tracer (runtime/profiling.py: ``tracer``, ``block``,
``span``, ``count``) and its spans and counters in the live path.

  * off: every span site returns the shared no-op context and nothing
    is recorded;
  * on: nesting and parent positions, the ring of whole blocks, the
    counters, the window of blocks a reader takes;
  * under a torch.profiler session (``Profiler(device="cpu")``) the
    ``te.*`` ranges nest as the spans in memory do;
  * a test-size ``Pipeline`` on the CPU (fused chain, TEA carriers, voice
    on the device pool's plain decoder with fewer slots than voice
    carriers) gives the same frames and PCM traced and untraced, every
    span of the issue's table and every counter, and no span's children
    outlast it;
  * on the card (marked ``cuda``): the step's kernels ran inside
    ``te.step``.

No JAX here, so the card's run can take the file alone:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu_torch import golden  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402
from tetraear_tpu_torch.frame.decoder import TetraDecoder  # noqa: E402
from tetraear_tpu_torch.runtime import profiling as prof  # noqa: E402

FS = 2.304e6
EIGHT = [(i - 4) * 25_000 + 12_500.0 for i in range(8)]
N_BLOCKS = 3

SPANS = ("block", "ingest", "step", "fetch", "frames_of", "assemble",
         "hits", "select", "parse", "decode", "soft_rows", "key_plan",
         "tea", "key_score", "voice_prepare", "v1", "voice_synth", "v2",
         "handle_frames")
PARENT = {"ingest": "block", "step": "block", "fetch": "block",
          "frames_of": "block", "voice_prepare": "block",
          "voice_synth": "block", "handle_frames": "block",
          "v1": "voice_prepare", "v2": "voice_synth",
          **{n: "frames_of" for n in ("assemble", "hits", "select",
                                      "parse", "decode", "soft_rows",
                                      "key_plan", "tea", "key_score")}}
COUNTERS = ("hits", "candidates", "frames", "key_frames", "keys_scored",
            "decrypted", "tea_rows", "voice_candidates", "v1_rows",
            "v2_slots", "v2_launches", "v2_evictions", "launches")
KEY_FIELDS = ("carrier", "stream_symbol", "position", "burst_crc", "type",
              "sds_message", "encrypted", "decrypted", "key_used",
              "decrypted_bytes", "tdma", "has_voice")


@pytest.fixture
def tr():
    """The process's tracer, emptied, switched off again afterwards."""
    t = prof.tracer()
    t.enable(False)
    t.reset()
    yield t
    t.enable(False)
    t.reset()


def test_off_records_nothing_and_returns_the_null_context(tr):
    assert not tr.on
    assert prof.block() is prof.NULL_SPAN
    assert prof.span("x") is prof.NULL_SPAN
    assert prof.span("step", torch.device("cpu")) is prof.NULL_SPAN
    with prof.block():
        with prof.span("x") as s:
            assert s is None
    prof.read_device()
    assert not tr.blocks and not tr.totals and not tr.counts
    assert tr.report() == {}
    # on, a span outside any block records nothing either
    tr.enable()
    assert prof.span("x") is prof.NULL_SPAN
    assert not tr.blocks


def test_spans_nest_with_their_parents(tr):
    tr.enable()
    with prof.block():
        with prof.span("a"):
            with prof.span("b"):
                pass
            with prof.span("c"):
                pass
        with prof.span("d"):
            pass
    (rec,) = tr.blocks
    assert rec.index == 1 and rec.name == "block"
    assert [(s[0], s[3]) for s in rec.spans] == [
        ("block", -1), ("a", 0), ("b", 1), ("c", 1), ("d", 0)]
    for name, t0, t1, parent in rec.spans:
        assert t0 <= t1
        if parent >= 0:
            p = rec.spans[parent]
            assert p[1] <= t0 and t1 <= p[2]
    rep = tr.report()
    assert set(rep) == {"block", "a", "b", "c", "d"}
    assert rep["a"]["calls"] == 1
    assert rep["block"]["total_s"] >= rep["a"]["total_s"] + \
        rep["d"]["total_s"]
    # a block opened inside a block is a plain span of it
    with prof.block():
        with prof.block("inner"):
            pass
    assert [(s[0], s[3]) for s in tr.blocks[-1].spans] == [
        ("block", -1), ("inner", 0)]


def test_ring_keeps_the_last_whole_blocks(tr):
    tr.enable()
    for _ in range(prof.BLOCKS_KEPT + 5):
        with prof.block():
            with prof.span("a"):
                pass
    assert len(tr.blocks) == prof.BLOCKS_KEPT
    assert tr.blocks[0].index == 6
    assert tr.blocks[-1].index == prof.BLOCKS_KEPT + 5
    assert all(len(b.spans) == 2 for b in tr.blocks)
    assert tr.report()["a"]["calls"] == prof.BLOCKS_KEPT + 5


def test_counters_always_on_and_kept_by_block(tr):
    prof.count("hits", 3)                       # off: running totals only
    assert tr.counters() == {"hits": 3} and not tr.blocks
    tr.enable()
    with prof.block():
        prof.count("hits", 4)
        prof.count("frames", 2)
        prof.count("hits", 1)
    with prof.block():
        prof.count("frames", 7)
    assert [b.counts for b in tr.blocks] == [{"hits": 5, "frames": 2},
                                            {"frames": 7}]
    assert tr.counters() == {"hits": 8, "frames": 9}


def test_window_takes_the_blocks_that_started_in_it(tr):
    tr.enable()
    starts = []
    for _ in range(5):
        with prof.block():
            starts.append(tr._cur.start)
    with prof.block("dispatch"):
        pass
    got = tr.window(starts[1], starts[4])
    assert [b.index for b in got] == [2, 3, 4]
    assert [b.index for b in tr.window(starts[0], float("inf"))] == \
        [1, 2, 3, 4, 5]
    assert [b.index for b in tr.window(0.0, float("inf"), "dispatch")] == [6]
    with prof.block():
        with prof.span("a"):
            pass
        with prof.span("a"):
            pass
    rec = tr.blocks[-1]
    assert rec.ms("a") == pytest.approx(
        1e3 * sum(s[2] - s[1] for s in rec.spans[1:]))


def test_profiler_ranges_nest_as_the_spans(tr, tmp_path):
    tr.enable()
    with prof.block():                       # no session: no ranges
        with prof.span("a"):
            pass
    with prof.Profiler(tmp_path, device="cpu") as p:
        with prof.block():
            with prof.span("a"):
                with prof.span("b"):
                    torch.ones(4).sum()
            with prof.span("c"):
                pass
    with prof.block():
        pass
    events = json.loads(p.trace_path.read_text())["traceEvents"]
    te = sorted((e for e in events if e.get("ph") == "X"
                 and str(e.get("name", "")).startswith("te.")),
                key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in te] == ["te.block", "te.a", "te.b", "te.c"]

    def inner(e, outer):
        return outer["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    rec = tr.blocks[1]
    by_name = {e["name"][3:]: e for e in te}
    for name, _t0, _t1, parent in rec.spans[1:]:
        pname = rec.spans[parent][0]
        assert inner(by_name[name], by_name[pname])
        # the innermost range around each is its parent's
        around = [e for e in te if e is not by_name[name]
                  and inner(by_name[name], e)]
        assert min(around, key=lambda e: e["dur"]) is by_name[pname]


# -- the live path --------------------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    common = TetraDecoder().common_keys
    bl = CarrierBankDemod(fs=FS, freqs_hz=EIGHT, frontend="fft").block_len
    iq, _ = golden.fleet_capture(
        FS, EIGHT, [0, 1], N_BLOCKS * bl, seed=3,
        encrypted={2: ("TEA1", common["TEA1"][0]),
                   3: ("TEA2", common["TEA2"][0]),
                   4: ("TEA1", bytes(range(10)))},
        voice={5: 0, 6: 4})
    return iq, bl


def _pipe(frames=None, audio=None):
    cfg = PipelineConfig(sample_rate=FS, carrier_offsets_hz=tuple(EIGHT),
                         frontend="fft", carrier_afc=False,
                         detect_gate=False, device="cpu",
                         device_voice=True, device_voice_slots=1)
    return Pipeline(cfg, on_frame=None if frames is None else frames.append,
                    on_audio=None if audio is None else audio.append)


def _run(iq, bl) -> tuple:
    frames, audio = [], []
    pipe = _pipe(frames, audio)
    try:
        for i in range(N_BLOCKS):
            pipe.process_block(iq[i * bl:(i + 1) * bl])
    finally:
        pipe.close()
    return [{k: f.get(k) for k in KEY_FIELDS} for f in frames], audio


@pytest.fixture(scope="module")
def runs(capture):
    """(untraced frames and PCM, traced frames and PCM, the traced
    blocks, the counters of the untraced run)."""
    t = prof.tracer()
    t.enable(False)
    t.reset()
    try:
        off = _run(*capture)
        off_counts = t.counters()
        assert not t.blocks and not t.totals
        t.enable()
        on = _run(*capture)
        return off, on, list(t.blocks), off_counts
    finally:
        t.enable(False)
        t.reset()


def test_pipeline_same_frames_and_pcm_traced_and_untraced(runs):
    (f_off, a_off), (f_on, a_on), blocks, _ = runs
    assert f_off == f_on
    assert len(a_off) == len(a_on) and a_off
    for x, y in zip(a_off, a_on):
        np.testing.assert_array_equal(x, y)
    assert sum(bool(f["decrypted"]) for f in f_on) >= 2
    assert any(f["has_voice"] for f in f_on)


def test_pipeline_block_spans_and_counters(runs):
    (f_on, _), blocks, off_counts = runs[1], runs[2], runs[3]
    assert len(blocks) == N_BLOCKS
    for rec in blocks:
        names = [s[0] for s in rec.spans]
        assert names[0] == "block" and names.count("block") == 1
        assert set(SPANS) <= set(names), set(SPANS) - set(names)
        for name, _t0, _t1, parent in rec.spans[1:]:
            assert rec.spans[parent][0] == PARENT[name], name
        assert set(rec.counts) == set(COUNTERS)
        c = rec.counts
        assert c["candidates"] <= c["hits"]
        assert c["key_frames"] >= 2 and c["tea_rows"] >= 2 * c["key_frames"]
        assert c["decrypted"] <= c["key_frames"] <= c["keys_scored"]
        assert c["v1_rows"] == c["voice_candidates"] >= 2
        # the voice carriers on one decoder slot: a launch a carrier, and
        # each evicts the one before
        assert c["v2_slots"] == c["v2_launches"] >= 2
        assert c["v2_evictions"] >= 1
        assert c["launches"] == 0                # plain versions count none
        assert not rec.device_ms                 # no CUDA events on the CPU
    assert sum(b.counts["frames"] for b in blocks) == len(f_on)
    # counters run untraced too, and count the same
    on_counts = {k: sum(b.counts[k] for b in blocks) for k in COUNTERS}
    assert off_counts == on_counts


def test_children_never_exceed_their_parent(runs):
    for rec in runs[2]:
        kids = {}
        for i, (_name, t0, t1, parent) in enumerate(rec.spans):
            if parent >= 0:
                p = rec.spans[parent]
                assert p[1] <= t0 <= t1 <= p[2]
                kids[parent] = kids.get(parent, 0.0) + (t1 - t0)
        for parent, total in kids.items():
            p = rec.spans[parent]
            assert total <= p[2] - p[1]


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the step's kernels run there)")


@pytest.mark.cuda
def test_step_kernels_inside_te_step(card, tr, tmp_path):
    """Traced under the program's Profiler, every kernel a block's step
    launched was launched inside ``te.step``, and the step's CUDA-event
    milliseconds were read in ``fetch``."""
    cfg = PipelineConfig(sample_rate=FS, carrier_offsets_hz=tuple(EIGHT),
                         frontend="fft", carrier_afc=False,
                         detect_gate=False, device="cuda", voice=False)
    pipe = Pipeline(cfg)
    iq = golden.fleet_capture(FS, EIGHT, range(8), 3 * pipe.block_len,
                              seed=5)
    bl = pipe.block_len
    tr.enable()
    try:
        pipe.process_block(iq[:bl])                       # warm
        with prof.Profiler(tmp_path) as p:
            pipe.process_block(iq[bl:2 * bl])
    finally:
        pipe.close()
    assert tr.blocks[-1].device_ms["step"] > 0
    events = json.loads(p.trace_path.read_text())["traceEvents"]
    # the host's range (the device's copy of it is a gpu_user_annotation)
    steps = [e for e in events if e.get("name") == "te.step"
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert len(steps) == 1, steps
    s0, s1 = steps[0]["ts"], steps[0]["ts"] + steps[0]["dur"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    # each kernel's launch call on the host (runtime or driver API)
    launches = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    inside = {e["args"]["correlation"] for e in launches
              if s0 <= e["ts"] <= s1}
    names = [e["name"] for e in events if e.get("cat") == "kernel"
             and e["args"].get("correlation") in inside]
    for kernel in ("fft2p", "band_synth", "fused_backhalf"):
        assert any(kernel in n for n in names), (kernel, names)
