"""The port's UI models (tetraear_tpu_torch/ui) against the JAX package's.

The spectrum math, the frames-table filters, the status tracker (with a
fixed ``now``) and the two recorders run through both packages on the
same inputs made from a seed: integers and WAV PCM bit-equal, floats
within 1e-6 relative.  Then the curses dashboard, with a stub screen,
over each package's Pipeline (the port's with ``device="cpu"``) on the
synthetic source, with and without voice: frames, spectrum row and voice
PCM equal; and each package's dashboard ``main`` with curses replaced by
the stub screen.
"""

import contextlib
import importlib
import io
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PKGS = ("tetraear_tpu", "tetraear_tpu_torch")
RTOL = 1e-6


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _pair(name: str) -> tuple:
    return tuple(_mod(pkg, name) for pkg in PKGS)


def _close(a, b) -> None:
    """Integers (and bools) bit-equal, floats within RTOL relative."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind in "fc":
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(b, a)


def _wav_pcm(path) -> tuple:
    with wave.open(str(path)) as wf:
        return (wf.getframerate(), wf.getnchannels(),
                np.frombuffer(wf.readframes(wf.getnframes()), np.int16))


# -- spectrum ----------------------------------------------------------------

def _tone_iq(rng, n: int) -> np.ndarray:
    t = np.arange(n) / 2.4e6
    f0 = rng.uniform(-1e6, 1e6)
    iq = np.exp(2j * np.pi * f0 * t) + 0.1 * (rng.standard_normal(n)
                                              + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


SPECTRUM_CASES = {
    "colormap_rgb": lambda m, rng: m.colormap_rgb(
        rng.uniform(-0.2, 1.2, (7, 33))),
    "power_spectrum_db": lambda m, rng: m.power_spectrum_db(
        _tone_iq(rng, 4096)),
    "power_spectrum_db_short": lambda m, rng: m.power_spectrum_db(
        _tone_iq(rng, 1000), fft_size=2048),
    "find_peak": lambda m, rng: m.find_peak(
        m.power_spectrum_db(_tone_iq(rng, 2048)), 2.4e6),
    "estimate_bandwidth": lambda m, rng: np.float64(m.estimate_bandwidth(
        m.power_spectrum_db(_tone_iq(rng, 2048)), 2.4e6,
        drop_db=float(rng.uniform(3, 12)))),
    "zoom_slice": lambda m, rng: [m.zoom_slice(rng.normal(size=2048), z)
                                  for z in (0.5, 1.0, 2.5, 10.0, 300.0)],
    "auto_calibrate": lambda m, rng: m.auto_calibrate(
        rng.normal(-80, 6, 2048)),
}


@pytest.mark.parametrize("case", sorted(SPECTRUM_CASES))
def test_spectrum_math_equal(case):
    want, got = (SPECTRUM_CASES[case](m, np.random.default_rng(5))
                 for m in _pair("ui.spectrum"))
    if isinstance(want, list):
        for w, g in zip(want, got, strict=True):
            _close(w, g)
    else:
        _close(want, got)


def test_denoiser_and_waterfall_equal():
    """SpectrumDenoiser's state and WaterfallBuffer's rows after a seeded
    sequence of spectra (a width change resets the denoiser; rows are
    resampled to the buffer's width)."""
    outs = []
    for m in _pair("ui.spectrum"):
        rng = np.random.default_rng(11)
        den, wf = m.SpectrumDenoiser(alpha=0.3), m.WaterfallBuffer(50, 6)
        seq = []
        for i in range(9):
            p = rng.normal(-70, 8, 2048 if i != 4 else 1024)
            seq.append(den(p))
            wf.floor_db, wf.ceiling_db = -95.0 + i, -20.0 - i
            wf.push(seq[-1])
        outs.append((seq, wf.rows.copy()))
    for w, g in zip(outs[0][0], outs[1][0], strict=True):
        _close(w, g)
    _close(outs[0][1], outs[1][1])


# -- filters -----------------------------------------------------------------

def _frames(seed: int, n: int, type_choices) -> list:
    """Frame dicts with every field the filters, tables and stores read."""
    rng = np.random.default_rng(seed)
    texts = ("[TXT] UNIT 4 ON SCENE", "[BIN] 0a0b", "[TXT] HOLD", None,
             "[BIN-ENC] SDS (Binary/Encrypted) - 8 bytes | 00")
    out = []
    for _ in range(n):
        f = {"number": int(rng.integers(0, 18)),
             "type_name": str(rng.choice(type_choices)),
             "carrier": int(rng.integers(0, 3)),
             "burst_crc": bool(rng.integers(0, 2)),
             "encrypted": bool(rng.integers(0, 2))}
        f["decrypted"] = f["encrypted"] and bool(rng.integers(0, 2))
        text = texts[int(rng.integers(len(texts)))]
        if text:
            f["sds_message"] = text
        r = int(rng.integers(0, 4))
        if r:
            meta = {"talkgroup_id": int(rng.integers(1, 5)) * 100,
                    "source_ssi": 7000 + int(rng.integers(0, 4)),
                    "call_type": "group"}
            if r == 2:
                meta["mcc"], meta["mnc"] = 260, int(rng.integers(1, 4))
            f["call_metadata"] = meta
        out.append(f)
    return out


@pytest.mark.parametrize("read_choice", range(3))
def test_frame_filter_equal(read_choice):
    """Every type and encryption choice under one readability choice, and
    is_readable, on the same seeded frames."""
    ref, port = _pair("ui.filters")
    assert (ref.TYPE_CHOICES, ref.ENC_CHOICES, ref.READ_CHOICES) == (
        port.TYPE_CHOICES, port.ENC_CHOICES, port.READ_CHOICES)
    frames = _frames(3, 200, ref.TYPE_CHOICES[1:])
    assert ([ref.is_readable(f) for f in frames]
            == [port.is_readable(f) for f in frames])
    rc = ref.READ_CHOICES[read_choice]
    for tc in ref.TYPE_CHOICES:
        for ec in ref.ENC_CHOICES:
            want = ref.FrameFilter(tc, ec, rc).filter(frames)
            got = port.FrameFilter(tc, ec, rc).filter(frames)
            assert got == want, (tc, ec, rc)


# -- status ------------------------------------------------------------------

def test_status_tracker_equal():
    """The detection state machine over a seeded stream of stats with a
    fixed clock (now=), signal losses included."""
    rng = np.random.default_rng(9)
    trackers = [m.TetraStatusTracker(min_detect_s=2.0)
                for m in _pair("ui.status")]
    now = 1000.0
    for _ in range(300):
        now += float(rng.uniform(0, 0.8))
        frames = int(rng.integers(0, 30))
        stats = {"frames": frames,
                 "signal_present": bool(rng.random() < 0.85),
                 "valid_frames": int(rng.integers(0, frames + 1)),
                 "crc_pass": int(rng.integers(0, frames + 1)),
                 "encrypted": int(rng.integers(0, 5)),
                 "decrypted": int(rng.integers(0, 5))}
        want, got = (t.evaluate(stats, now=now) for t in trackers)
        assert want["state"] == got["state"] and want["text"] == got["text"]
        _close({k: v for k, v in want.items() if k not in ("state", "text")},
               {k: v for k, v in got.items() if k not in ("state", "text")})


# -- recorders ---------------------------------------------------------------

def test_recording_controller_equal(tmp_path):
    """Four recordings of seeded voice PCM (one silent, deleted), a player
    fed while monitoring, and max_recordings pruning: the same files kept
    (by order) with bit-equal PCM, the same audio played."""
    kept, played = {}, {}
    for pkg in PKGS:
        m = _mod(pkg, "ui.recording")
        rng = np.random.default_rng(21)
        heard = []
        rc = m.RecordingController(tmp_path / pkg, delete_silent=True,
                                   player=heard.append, max_recordings=2)
        rc.set_monitor(True)
        paths = []
        for i in range(4):
            rc.start()
            for _ in range(3):
                chunk = (np.zeros(480, np.float32) if i == 1 else
                         (0.3 * rng.standard_normal(480)).astype(np.float32))
                rc.feed(chunk)
            paths.append(rc.stop())
        rc.close()
        assert paths[1] is None                      # silent: deleted
        kept[pkg] = [_wav_pcm(p) if p.exists() else None
                     for p in paths if p is not None]
        played[pkg] = heard
    assert [k is None for k in kept[PKGS[0]]] == [True, False, False]
    for w, g in zip(kept[PKGS[0]], kept[PKGS[1]], strict=True):
        if w is None:
            assert g is None
            continue
        assert w[:2] == g[:2] == (8000, 1)
        np.testing.assert_array_equal(g[2], w[2])
    for w, g in zip(*played.values(), strict=True):
        np.testing.assert_array_equal(g, w)


def test_raw_fm_recorder_equal(tmp_path):
    """RawFMRecorder at 2.4 Msps: seeded FM audio fed in uneven chunks
    (the resampler's pending samples and history carried), 48 kHz WAV
    PCM bit-equal."""
    pcm = {}
    for pkg in PKGS:
        m = _mod(pkg, "ui.recording")
        rng = np.random.default_rng(4)
        rec = m.RawFMRecorder(tmp_path / pkg, fs=2.4e6)
        (tmp_path / pkg).mkdir()
        rec.feed(np.ones(100, np.float32))          # not recording: dropped
        rec.start()
        t = 0
        for n in (7_001, 130_800, 50, 64_000, 99_999):
            x = 0.4 * np.sin(2 * np.pi * 700 * (t + np.arange(n)) / 2.4e6)
            rec.feed((x + 0.01 * rng.standard_normal(n)).astype(np.float32))
            t += n
        pcm[pkg] = _wav_pcm(rec.stop())
    assert pcm[PKGS[0]][:2] == pcm[PKGS[1]][:2] == (48_000, 1)
    assert len(pcm[PKGS[0]][2]) > 5_000
    np.testing.assert_array_equal(pcm[PKGS[1]][2], pcm[PKGS[0]][2])


# -- dashboard ---------------------------------------------------------------

class StubScr:
    """A curses screen that keeps what is drawn."""

    def __init__(self):
        self.lines = {}

    def nodelay(self, *_):
        pass

    def getmaxyx(self):
        return (24, 80)

    def erase(self):
        self.lines = {}

    def addnstr(self, y, x, text, n, *attr):
        self.lines[y] = text[:n]

    def refresh(self):
        pass

    def getch(self):
        return -1


FRAME_KEYS = ("number", "type_name", "carrier", "burst_crc", "encrypted",
              "decrypted", "sds_message", "stream_symbol")


def _dashboard(pkg: str, voice: bool, blocks: int) -> tuple:
    api = _mod(pkg, "api")
    sources = _mod(pkg, "runtime.sources")
    dash_mod = _mod(pkg, "ui.dashboard")
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    pipe = api.Pipeline(api.PipelineConfig(
        sample_rate=2.4e6, detect_gate=False, voice=voice, **kw))
    audio = []
    pipe.on_audio = audio.append
    src = sources.SyntheticTetraSource(sample_rate=2.4e6, snr_db=25, seed=2,
                                       voice=voice)
    dash = dash_mod.Dashboard(StubScr(), pipe, src, "test")
    dash.last_draw = -1e9
    dash.run(max_blocks=blocks)
    frames = [tuple(f.get(k) for k in FRAME_KEYS) for f in dash.frames]
    return (frames, dash._spectrum_row(40), audio, pipe.stats.frames,
            pipe.stats.voice_frames)


@pytest.mark.parametrize("voice", [False, True], ids=["sds", "voice"])
def test_dashboard_equal(voice):
    """Dashboard.run over each package's Pipeline on the synthetic
    source (2.4 Msps, 25 dB, seed 2), 3 blocks: the frames it keeps, the
    spectrum row it draws and the voice PCM equal."""
    want, got = (_dashboard(pkg, voice, 3) for pkg in PKGS)
    assert want[3] >= 3 and got[0] == want[0]
    assert len(got[1]) == 40 and got[1] == want[1]
    assert got[3:] == want[3:]
    if voice:
        assert want[4] > 0 and len(want[2]) > 0
    assert len(got[2]) == len(want[2])
    for w, g in zip(want[2], got[2]):
        np.testing.assert_array_equal(g, w)


def test_dashboard_main_equal(monkeypatch):
    """Each package's dashboard main (the port's with --device cpu) on
    the synthetic source for 2 blocks, curses.wrapper replaced by the
    stub screen: the same summary line."""
    import curses
    outs = {}
    for pkg in PKGS:
        screens = []

        def wrapper(fn, screens=screens):
            screens.append(StubScr())
            return fn(screens[-1])
        monkeypatch.setattr(curses, "wrapper", wrapper)
        argv = ["--source", "synthetic", "--max-blocks", "2"]
        if pkg.endswith("_torch"):
            argv += ["--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert _mod(pkg, "ui.dashboard").main(argv) == 0
        outs[pkg] = buf.getvalue()
        assert len(screens) == 1
    assert outs[PKGS[1]] == outs[PKGS[0]]
    assert "frames=" in outs[PKGS[0]] and "frames=0 " not in outs[PKGS[0]]
