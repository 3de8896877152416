"""The benchmark's own tests (run from the checkout's root):

    python -m pytest benchmark/tests -q              # on the CPU, ~3 min
    python -m pytest benchmark/tests -q -m cuda      # on the card

The CPU tests drive the harness at a test size (8 carriers at 2.304
Msps, ``tests/data``) with the program on its CPU path; ``run_cell`` is
called directly, which skips the harness's look for a chip.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

from tebench import cells, check, harness, roofline, speechcode  # noqa: E402
from tebench import synth, traffic  # noqa: E402

SEED = 2_718_281_828_459
LIMIT = 0.03           # the test cell's limit on failed_share


def _tiny_root(tmp: Path, config: str = "small") -> tuple:
    """A copy of the benchmark with the test-size cell ``<config>.tiny``."""
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(DATA / "small.json", root / "configs" / "small.json")
    shutil.copy(DATA / "tiny.json", root / "traffic" / "tiny.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = f"{config}.tiny"
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": "tiny", "chips": 1, "why": "test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "limits" / f"{name}.json").write_text(json.dumps(
        {"failed_share": {"limit": LIMIT}}))
    return cells.load(name, tmp / "BENCHMARK.json", root), root


def _run(tmp, config="small", seconds=1.0, device="cpu", control=False,
         seed=SEED):
    cell, _ = _tiny_root(tmp, config)
    return harness.run_cell(cell, seed, seconds, trace=True, device=device,
                            t_start=time.perf_counter(), control=control)


# -- the generator ------------------------------------------------------------

def test_traffic_deterministic_and_mixed():
    tr = json.loads((DATA / "tiny.json").read_text())
    tr.update(active_share=0.25)
    a = traffic.make(64, 2016, tr, SEED, 128.0)
    b = traffic.make(64, 2016, tr, SEED, 128.0)
    c = traffic.make(64, 2016, tr, SEED + 1, 128.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    for bits, active, truth in (a, c):
        roles = [truth.carriers[int(ci)].role for ci in active]
        assert {r: roles.count(r) for r in set(roles)} == \
            {"sds": 4, "tea_common": 4, "tea_unknown": 2, "voice": 6}
        voice = [car for car in truth.carriers.values() if car.role == "voice"]
        assert sum(bool(car.stolen.any()) for car in voice) == 2
        # every stream is periodic: its phase steps sum to 0 mod 2 pi
        assert (synth.points(bits)[:, -1] == 0).all()


def test_tea_common_keys_decrypt_and_unknown_keys_recorded():
    tr = json.loads((DATA / "tiny.json").read_text())
    _, _, truth = traffic.make(8, 2016, tr, SEED, 128.0)
    for car in truth.carriers.values():
        if car.role == "tea_common":
            from tebench import keyplan
            got = keyplan.decision(car.payload, car.family)
            assert got["plaintext"] == car.plaintext


def test_speech_encoder_matches_the_standard_codec():
    """The numpy TCH/S encoder against the program's ETSI channel codec
    (g++), on random frames and stolen half slots."""
    import ctypes

    from tetraear_tpu_torch import native
    lib = native.codec()._LIB
    p16 = ctypes.POINTER(ctypes.c_int16)
    rng = np.random.default_rng(3)
    fa = rng.integers(0, 2, (20, 137)).astype(np.uint8)
    fb = rng.integers(0, 2, (20, 137)).astype(np.uint8)
    mine, half = speechcode.encode_slots(fa, fb), speechcode.encode_stolen(fa)
    for i in range(20):
        params = np.zeros((2, 138), np.int16)
        params[0, 1:], params[1, 1:] = fa[i], fb[i]
        block = np.zeros(690, np.int16)
        lib.tetra_channel_encode(params.ctypes.data_as(p16),
                                 block.ctypes.data_as(p16))
        soft = np.concatenate([block[1:115], block[116:230],
                               block[231:345], block[346:436]])[:432]
        assert np.array_equal((soft > 0).astype(np.uint8), mine[i])
        s216 = np.zeros(216, np.int16)
        lib.tetra_channel_encode_stolen(
            np.ascontiguousarray(fa[i].astype(np.int16)).ctypes.data_as(p16),
            s216.ctypes.data_as(p16))
        assert np.array_equal((s216 > 0).astype(np.uint8), half[i])
    speechcode.force_header(fa, fb)
    assert (speechcode.encode_slots(fa, fb)[:, :4] == (0, 1, 0, 0)).all()


def test_capture_demodulates_to_the_sent_symbols():
    """A plain matched filter, sampled at each carrier's delay, reads the
    sent phase steps back from the synthesized capture."""
    import torch
    tr = json.loads((DATA / "tiny.json").read_text())
    fs, bl = 2.304e6, 258048
    bits, active, truth = traffic.make(8, 2016, tr, SEED, 128.0)
    n = bl * 3
    offs = np.asarray(harness.offsets({"n_carriers": 8, "grid_hz": 25000}))
    bins = np.round(offs[active] / (fs / n)).astype(np.int64)
    delays = np.array([truth.carriers[int(c)].delay for c in active])
    x = synth.capture(synth.points(bits), bins, delays, n, fs, 60.0, 1,
                      torch.device("cpu")).numpy()
    spec = np.fft.fft(x)
    k = np.arange(-int(12150 * n / fs), int(12150 * n / fs) + 1)
    for row, c in enumerate(active):
        y = np.zeros(n, complex)
        y[k % n] = spec[(bins[row] + k) % n] * synth.rrc(
            torch.tensor(k * fs / n)).numpy()
        pts = np.fft.ifft(y)[int(round(delays[row]))::128]
        got = np.round(np.angle(pts * np.conj(np.roll(pts, 1)))
                       / (np.pi / 4)).astype(int) % 8
        sym = (bits[row, 0::2].astype(int) << 1) | bits[row, 1::2]
        assert np.array_equal(got, synth._STEP[sym] % 8), c


def test_four_step_inverse_fft():
    import torch
    x = torch.randn(3 * 2 ** 12, dtype=torch.complex64)
    y = synth.ifft_big(x.clone(), 64)
    assert float((y - torch.fft.ifft(x)).abs().max()) < 1e-6


# -- the files, found by name ---------------------------------------------------

def test_new_cell_config_mix_metric_span_found_without_edits(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(DATA / "small.json", root / "configs" / "newcfg.json")
    shutil.copy(DATA / "tiny.json", root / "traffic" / "newmix.json")
    (root / "metrics" / "new_metric.py").write_text(
        "SPANS = ('new_span',)\n\ndef compute(run):\n    return 42.0\n")
    (root / "spans" / "new_span.json").write_text(json.dumps(
        {"on": "pipeline.runner", "method": "ingest", "clock": "host"}))
    (root / "limits" / "newcfg.newmix.json").write_text(json.dumps(
        {"failed_share": {"limit": 0.03}}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                              "traffic": "newmix", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "new_metric", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "x", "moves": "realtime_carriers",
                              "workloads": ["newcfg.newmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load("newcfg.newmix", tmp_path / "BENCHMARK.json", root)
    assert cell.config["n_carriers"] == 8
    assert cell.traffic["cycle_blocks"] == 3
    assert "new_metric" in [m["name"] for m in cell.per_layer]
    assert cells.metric_reader("new_metric", root).compute(None) == 42.0
    points = cells.span_points(cell.per_layer, root)
    assert points["new_span"]["on"] == "pipeline.runner"
    # a span point only the new metric reads is installed only where a
    # cell reports that metric
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        c = cells.load(w["name"], tmp_path / "BENCHMARK.json", root)
        assert "new_span" not in cells.span_points(c.per_layer, root)
    spec_here = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec_here["workloads"]:
        c = cells.load(w["name"], ROOT / "BENCHMARK.json")
        for m in c.end_to_end + c.per_layer:
            assert hasattr(cells.metric_reader(m["name"]), "compute")


def test_spans_resolve_and_wrap_only_what_metrics_name():
    from tebench.record import Recorder, resolve

    class Runner:
        def ingest(self, x):
            return x + 1

        def step(self, x):
            return x

    class Pipe:
        device = type("D", (), {"type": "cpu"})()

        def __init__(self):
            self.runner = Runner()

        def _handle_frame(self, f):
            return f

    pipe = Pipe()
    assert resolve(pipe, "pipeline") is pipe
    assert resolve(pipe, "pipeline.runner") is pipe.runner
    with pytest.raises(ValueError):
        resolve(pipe, "runner")
    metrics = [{"name": "ingest_ms"}]
    rec = Recorder({})
    rec.install_spans(pipe, cells.span_points(metrics))
    assert pipe.runner.ingest(1) == 2
    assert "ingest" in pipe.runner.__dict__
    assert "step" not in pipe.runner.__dict__
    assert "_handle_frame" not in pipe.__dict__
    assert len(rec.spans["ingest"]) == 1


# -- the roofline count -----------------------------------------------------------

def test_roofline_counting_small():
    fs, c, bl = 2.304e6, 8, 258048
    nbytes, ops = roofline.step_work(fs, c, bl)
    syms = bl / fs * 18000.0                      # 2016
    assert nbytes == 8 * bl + c * (syms / 4 + 4)
    assert ops == pytest.approx(5 * bl * np.log2(bl)
                                + c * 5 * 4032 * np.log2(4032))
    least, bound = roofline.least_step_s(fs, c, bl)
    assert bound == "memory" and least == pytest.approx(nbytes / 3.35e12)
    least, bound = roofline.least_step_s(589.824e6, 20480, 66650112)
    assert bound == "compute"


# -- the reference against the program, the control, the faults -------------------

def test_reference_agrees_with_the_program(tmp_path):
    res = _run(tmp_path, seconds=1.0)
    v = res["verdict"]
    assert v["missed"] == 0 and v["wrong"] == 0, v
    assert v["expected"] > 20 and v["judged"] > 20
    roles = set(res["watch"].values())
    assert {"sds", "tea_common", "tea_unknown", "voice"} <= roles


def test_off_slot_voice_frame_is_wrong_and_stays_out_of_the_reference():
    """A voice frame on no sent slot counts as wrong, and the reference's
    decoder state never takes its parameters: the frames after it are
    judged against the ETSI decoding of the sent frames alone."""
    tr = json.loads((DATA / "tiny.json").read_text())
    _, _, truth = traffic.make(8, 2016, tr, SEED, 128.0)
    ci, car = next((c, k) for c, k in sorted(truth.carriers.items())
                   if k.role == "voice")
    lat = car.lead + 255 * np.arange(truth.n_slots)
    on = [(0, ci, int(p), car.params[j], None) for j, p in enumerate(lat)]
    ref = check._reference_pcm(truth, car, on, {r[2]: (0, j)
                                                for j, r in enumerate(on)})
    good = [r[:4] + (a,) for r, a in zip(on, ref)]
    bogus = np.random.default_rng(1).integers(0, 2, (2, 138)).astype(
        np.int16)
    bogus[:, 0] = 0
    off = (0, ci, int(lat[1]) + 120, bogus, np.ones(480, np.float32))
    hi = truth.cycle_blocks - 1
    v = check.compare(truth, {ci: "voice"}, [], good, 0, hi)
    assert v["wrong"] == 0, v
    v = check.compare(truth, {ci: "voice"}, [], good[:2] + [off] + good[2:],
                      0, hi)
    assert v["wrong"] == 1 and v["details"] == {"voice_off_slot": 1}, v


def test_control_is_not_correct(tmp_path):
    res = _run(tmp_path, seconds=12.0, control=True)
    v = res["verdict"]
    assert res["run"].blocks >= 3
    assert v["missed"] > 0 and v["failed_share"] > LIMIT, v


def _patch_fault(monkeypatch, fault: str):
    from tetraear_tpu_torch.api import Pipeline
    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    if fault == "state_unchanged":
        step = DecodeRunner.step

        def stale(self, x, state):
            out, _ = step(self, x, state)
            return out, state
        monkeypatch.setattr(DecodeRunner, "step", stale)
    elif fault == "half_left_out":
        frames_of = DecodeRunner.frames_of

        def half(self, host):
            return [f for f in frames_of(self, host) if f["carrier"] % 2 == 0]
        monkeypatch.setattr(DecodeRunner, "frames_of", half)
    elif fault == "text_altered":
        frames_of = DecodeRunner.frames_of

        def altered(self, host):
            out = frames_of(self, host)
            for f in out:
                if f.get("sds_message"):
                    f["sds_message"] = f["sds_message"][:-1] + "#"
            return out
        monkeypatch.setattr(DecodeRunner, "frames_of", altered)
    elif fault == "speech_altered":
        synth_dev = Pipeline._synth_voice_device

        def altered(self, frames):
            synth_dev(self, frames)
            for f in frames:
                a = f.get("_voice_audio")
                if a is not None and a.size:
                    f["_voice_audio"] = a * np.float32(0.5)
        monkeypatch.setattr(Pipeline, "_synth_voice_device", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "text_altered", "speech_altered"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    _patch_fault(monkeypatch, fault)
    cell, _ = _tiny_root(tmp_path)
    res = harness.run_cell(cell, SEED + 5, 1.0, trace=False, device="cpu",
                           t_start=time.perf_counter())
    out, lines = harness.result_line(cell, res, False, "cpu", 1)
    assert out["correct"] is False, (fault, res["verdict"])
    assert list(out)[-1] == "check"


# -- the judged span: whole cycles past the window --------------------------------

JUMP = 10_000.0        # clock seconds each block takes under _blocks_clock


def _blocks_clock(mp):
    """``time.perf_counter`` jumps JUMP seconds at every
    ``Pipeline.process_block``, so that a window of ``--seconds`` (n - 0.5)
    x JUMP holds exactly n blocks however fast this CPU is; the program's
    tracer and the harness read the same clock."""
    from tetraear_tpu_torch.api import Pipeline
    real, jumps = time.perf_counter, [0.0]
    process = Pipeline.process_block

    def slow(self, block):
        jumps[0] += JUMP
        return process(self, block)
    mp.setattr(time, "perf_counter", lambda: real() + jumps[0])
    mp.setattr(Pipeline, "process_block", slow)


def _drop_position(mp, position: int, cell):
    """The timed path loses every frame that starts in one capture block
    of the cycle: failures at a fixed position, as a sound program's
    are."""
    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    frames_of = DecodeRunner.frames_of
    bs = int(cell.config["block_len"]) * 18000 // int(
        cell.config["sample_rate"])
    cb = int(cell.traffic["cycle_blocks"])

    def dropped(self, host):
        return [f for f in frames_of(self, host)
                if int(f["stream_symbol"]) // bs % cb != position]
    mp.setattr(DecodeRunner, "frames_of", dropped)


@pytest.fixture(scope="module")
def two_windows(tmp_path_factory):
    """One seed, windows of 4 and 8 blocks (cycle 3: they end at cycle
    positions 1 and 2), traced, with the frames of cycle position 1
    dropped: {blocks: (cell, result, tracer blocks kept)}."""
    from tetraear_tpu_torch.runtime import profiling
    tr = profiling.tracer()
    out = {}
    for n in (4, 8):
        cell, _ = _tiny_root(tmp_path_factory.mktemp(f"w{n}"))
        with pytest.MonkeyPatch.context() as mp:
            _blocks_clock(mp)
            _drop_position(mp, 1, cell)
            tr.enable()
            tr.reset()
            res = harness.run_cell(cell, SEED, (n - 0.5) * JUMP, trace=True,
                                   device="cpu", t_start=time.perf_counter())
            out[n] = (cell, res, list(tr.blocks))
        tr.enable(False)
        tr.reset()
    return out


def test_judged_span_is_whole_cycles(two_windows):
    for n, (cell, res, _) in two_windows.items():
        run, v = res["run"], res["verdict"]
        cb = int(cell.traffic["cycle_blocks"])
        judged = run.blocks + run.extra_blocks
        assert run.blocks == n and 0 <= run.extra_blocks < cb
        assert judged % cb == 0 and judged == -(-n // cb) * cb
        assert len(v["failed_by_cycle"]) == judged // cb
        assert len(v["failed_by_position"]) == cb
        assert sum(v["failed_by_cycle"]) == sum(v["failed_by_position"]) \
            == v["missed"] + v["wrong"] > 0


def test_blocks_past_the_window_are_in_no_metric(two_windows):
    """The extension's blocks are untimed and untraced: the window's
    blocks, block times and the tracer's records are those of the window
    alone, and the tracer is off after it."""
    from tebench import progtrace
    from tetraear_tpu_torch.runtime import profiling
    for n, (cell, res, kept) in two_windows.items():
        run = res["run"]
        warm = int(cell.config["warmup_blocks"])
        assert run.extra_blocks > 0
        assert len(run.block_times) == len(run.block_cpu) == run.blocks == n
        assert run.wall_s < (n + 0.5) * JUMP
        assert run.extra_s >= run.extra_blocks * JUMP
        assert len(kept) == warm + n
        assert all(b.start < run.t_hi for b in kept)
    tr = profiling.tracer()
    cell, res, kept = two_windows[8]
    tr.blocks.extend(kept)
    try:
        assert len(progtrace._window(res["run"])) == res["run"].blocks
    finally:
        tr.reset()
    assert not tr.on


def test_failed_by_cycle_same_however_the_window_ends(two_windows):
    """Windows of 4 and 8 blocks judge 2 and 3 whole cycles: every cycle
    after the first fails on the same slots, the dropped position holds
    the failures, and the longer run attempts one cycle's slots more."""
    (cell, a, _), (_, b, _) = two_windows[4], two_windows[8]
    va, vb = a["verdict"], b["verdict"]
    fa, fb = va["failed_by_cycle"], vb["failed_by_cycle"]
    assert (len(fa), len(fb)) == (2, 3)
    assert fa[1] == fb[1] == fb[2] > 0, (fa, fb)
    assert fa[0] == fb[0], (fa, fb)
    for v in (va, vb):
        pos = v["failed_by_position"]
        assert pos[1] == max(pos) > 0, pos
    truth = a["truth"]
    sent = sum(truth.n_slots for c, role in a["watch"].items()
               if role != "idle")
    assert vb["expected"] - va["expected"] == sent
    assert va["failed_share"] != vb["failed_share"]


def test_a_wrong_frame_counts_in_the_cycle_that_delivered_it():
    """A CRC-passing frame on no slot in each cycle's last symbols: the
    last cycle's starts past the span's last judged slot start, but its
    block is judged, and it counts there, once a cycle."""
    from tebench.frozen import sds
    tr = json.loads((DATA / "tiny.json").read_text())
    _, _, truth = traffic.make(8, 2016, tr, SEED, 128.0)
    ci, car = next((c, k) for c, k in sorted(truth.carriers.items())
                   if k.role == "sds")
    text = sds.parse_sds_data(car.payload)
    bs, ns, cb = truth.block_syms, truth.cycle_syms, truth.cycle_blocks
    lat = car.lead + 255 * np.arange(truth.n_slots)
    for k in (2, 3):
        frames = []
        for c in range(k):
            for j, p in enumerate(lat):
                s = c * ns + int(p)
                ok = bool(car.crc_ok[j])
                frames.append(((s + 254) // bs, ci, s, ok,
                               text if ok else None, False, False, None))
            s = c * ns + int(lat[-1]) + 100
            frames.append(((s + 254) // bs, ci, s, True, text, False, False,
                           None))
        v = check.compare(truth, {ci: "sds"}, frames, [], 0, k * cb - 1)
        assert v["details"] == {"crc_off_slot": k}, v
        assert v["failed_by_cycle"] == [1] * k
        assert v["failed_by_position"] == [0] * (cb - 1) + [k]


# -- what the runs load ----------------------------------------------------------

def test_imports_nothing_forbidden():
    """The harness, the generator and the reference load no module whose
    top-level name is jax, jaxlib, flax or tetraear_tpu (names compared
    whole); the reference loads nothing of tetraear_tpu_torch."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tebench.harness, tebench.traffic, tebench.synth\n"
        "import tebench.check, tebench.keyplan, tebench.refpcm\n"
        "import tebench.record, tebench.devtrace, tebench.roofline\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'tetraear_tpu',"
        " 'tetraear_tpu_torch'}))\n" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "[]", out.stdout
    assert harness.forbidden_modules() == [] or \
        "tetraear_tpu" not in harness.FORBIDDEN
    assert "tetraear_tpu_torch" not in [m.split(".")[0] for m in
                                        harness.FORBIDDEN]


def test_exits_without_the_program(tmp_path):
    dst = tmp_path / "bare"
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fleet1024.quiet",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(dst), capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_reference_agrees_on_the_card(tmp_path, card):
    res = _run(tmp_path, seconds=2.0, device="cuda")
    v = res["verdict"]
    assert v["missed"] == 0 and v["wrong"] == 0, v


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(tmp_path, card):
    res = _run(tmp_path, seconds=2.0, device="cuda", control=True)
    assert res["verdict"]["failed_share"] > LIMIT
