"""The port's PyQt6 window and capture thread against the JAX package's.

With the functional PyQt6 stub (tests/unit/qt_stub.py) installed, both
packages' ``ui.qt`` import and their windows build: the same seeded
frames fill the same Frames / Calls / Groups / Users / SDS cells, under
every filter too.  Each package's ``CaptureThread.run`` on a real
``threading.Thread`` over a finite capture of golden SDS slots (clear,
TEA1 and TEA2 under common keys) emits the same frames and statistics
and no ``error:`` status; and ``ModernTetraGUI.on_start`` with its
source redirected to a capture (SDS, and voice with REC and raw FM on)
runs its own signal wiring to the same tables and the same PCM.  The
port's window runs with ``device="cpu"``; without PyQt6 its ``main``
returns 1 naming the port's dashboard.
"""

import contextlib
import importlib
import io
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PKGS = ("tetraear_tpu", "tetraear_tpu_torch")
QT_MODULES = ("PyQt6", "PyQt6.QtCore", "PyQt6.QtGui", "PyQt6.QtWidgets",
              "tetraear_tpu.ui.qt", "tetraear_tpu_torch.ui.qt")
# the capture's SDS slots: (cipher or None, key, text); both keys are
# common keys (tools/generate_common_keys.py), so auto-decrypt finds them
SLOTS = ((None, None, "CLEAR TEXT ONE"),
         ("TEA1", "0123456789ABCDEF0123", "RELOCATE NOW"),
         ("TEA2", "0123456789ABCDEF0123456789ABCDEF", "GATE SEVEN OPEN"))
TIME_KEYS = ("uptime_s", "samples_per_s", "frames_per_s")
FRAME_KEYS = ("number", "type_name", "carrier", "burst_crc", "encrypted",
              "decrypted", "sds_message", "stream_symbol")


@pytest.fixture()
def qt(tmp_path, monkeypatch):
    """{pkg: its ui.qt} imported afresh over the stub; sys.modules is
    restored afterwards."""
    for name in QT_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
        del sys.modules[name]
    monkeypatch.syspath_prepend(str(REPO))
    from tests.unit import qt_stub
    qt_stub.install()
    monkeypatch.setenv("TETRAEAR_TPU_DATA_DIR", str(tmp_path / "data"))
    mods = {pkg: importlib.import_module(f"{pkg}.ui.qt") for pkg in PKGS}
    assert all(m.QT_AVAILABLE for m in mods.values())
    return mods


def _window(qt, pkg: str, records: Path):
    settings = importlib.import_module(f"{pkg}.utils.settings")
    s = settings.SettingsManager(records.parent / f"settings_{pkg}.json")
    s.set("records_dir", str(records))
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return qt[pkg].ModernTetraGUI(settings=s, **kw)


def _cells(table) -> list:
    return [[None if item is None else item.text() for item in row]
            for row in table._rows]


def _tables(win) -> dict:
    return {name: _cells(getattr(win, name)) for name in (
        "frames_table", "calls_table", "groups_table", "users_table",
        "sds_table")}


def _frames(seed: int, n: int) -> list:
    from tetraear_tpu_torch.ui.filters import TYPE_CHOICES
    rng = np.random.default_rng(seed)
    texts = ("[TXT] UNIT 4 ON SCENE", "[BIN] 0a0b", "[TXT] HOLD", None)
    out = []
    for _ in range(n):
        f = {"number": int(rng.integers(0, 18)),
             "type_name": str(rng.choice(TYPE_CHOICES[1:])),
             "carrier": int(rng.integers(0, 3)),
             "burst_crc": bool(rng.integers(0, 2)),
             "encrypted": bool(rng.integers(0, 2))}
        f["decrypted"] = f["encrypted"] and bool(rng.integers(0, 2))
        text = texts[int(rng.integers(len(texts)))]
        if text:
            f["sds_message"] = text
        if rng.integers(0, 3):
            f["call_metadata"] = {
                "talkgroup_id": int(rng.integers(1, 5)) * 100,
                "source_ssi": 7000 + int(rng.integers(0, 4)),
                "call_type": "group"}
            if rng.integers(0, 2):
                f["call_metadata"].update(mcc=260, mnc=2)
        out.append(f)
    return out


def test_gui_tables_equal(qt, tmp_path):
    """The same seeded frames through each window's on_frame: every
    table's cells equal, then the same after each filter change."""
    wins = [_window(qt, pkg, tmp_path / pkg) for pkg in PKGS]
    for f in _frames(17, 120):
        for w in wins:
            w.on_frame(dict(f))
    assert wins[0].frames_table.rowCount() == 120
    assert _tables(wins[1]) == _tables(wins[0])
    for box, choice in (("read_filter", "CRC-pass only"),
                        ("enc_filter", "Decrypted only"),
                        ("type_filter", "MAC-RESOURCE"),
                        ("read_filter", "Readable only"),
                        ("enc_filter", "All")):
        for w in wins:
            getattr(w, box).setCurrentText(choice)
        assert _tables(wins[1]) == _tables(wins[0]), (box, choice)


def sds_capture(path: Path, n_slots: int, seed: int) -> None:
    """2.4 Msps SDS slots cycling through SLOTS (encrypted with enc_mode
    1 where a cipher is named), 25 dB SNR, as a .cfile."""
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.ref import golden, modulator
    from tetraear_tpu_torch.runtime.sources import write_capture
    rng = np.random.default_rng(seed)
    slots = []
    for i in range(n_slots):
        alg, key, text = SLOTS[i % len(SLOTS)]
        pdu = golden.sds_text_payload(text)
        if alg:
            pdu += b"\x00" * ((-len(pdu)) % 8)
            pdu = TEADecryptor(bytes.fromhex(key), alg).encrypt(pdu)
        slots.append(golden.build_slot(golden.build_mac_resource_data_bits(
            pdu, rng=rng, enc_mode=1 if alg else 0), rng=rng))
    pad = rng.integers(0, 2, 64).astype(np.uint8)
    iq = modulator.generate_carrier(np.concatenate([pad] + slots), fs=2.4e6)
    write_capture(path, modulator.add_awgn(iq, 25, rng))


def voice_capture(path: Path, n_blocks: int) -> None:
    """n_blocks blocks of 130,800 samples of the synthetic voice source
    (speech slots from the codec), as a .cfile."""
    from tetraear_tpu_torch import native
    from tetraear_tpu_torch.runtime.sources import (SyntheticTetraSource,
                                                    write_capture)
    native.codec()
    src = SyntheticTetraSource(sample_rate=2.4e6, voice=True, seed=3)
    with src:
        write_capture(path, src.read_samples(n_blocks * 130_800))


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("captures")
    sds_capture(d / "sds.cfile", 9, seed=5)
    voice_capture(d / "voice.cfile", 3)
    return d


def _on_thread(fn) -> None:
    errors = []

    def body():
        try:
            fn()
        except BaseException as e:           # surfaced in the test
            errors.append(e)
    t = threading.Thread(target=body, name="capture")
    t.start()
    t.join(600)
    assert not t.is_alive()
    assert not errors, errors


def _capture_thread_run(qt, pkg: str, capture: Path) -> dict:
    """CaptureThread.run of ``pkg`` on a thread of its own over the
    capture; what it emitted, and its pipeline's final statistics."""
    api = importlib.import_module(f"{pkg}.api")
    sources = importlib.import_module(f"{pkg}.runtime.sources")
    kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    cfg = api.PipelineConfig(sample_rate=2.4e6, auto_decrypt=True, **kw)
    th = qt[pkg].CaptureThread(cfg, sources.FileIQSource(
        capture, sample_rate=2.4e6))
    got = {"frames": [], "stats": [], "status": [], "spectra": 0,
           "pipes": []}
    th.frame_decoded.connect(got["frames"].append)
    th.frame_decoded.connect(lambda _f: got["pipes"].append(th.pipeline))
    th.stats_update.connect(got["stats"].append)
    th.status_update.connect(got["status"].append)

    def spectrum(_p):
        got["spectra"] += 1
    th.spectrum_update.connect(spectrum)
    _on_thread(th.run)
    assert th.pipeline is None
    got["final"] = got["pipes"][-1].stats.as_dict()
    return got


def _untimed(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in TIME_KEYS}


def test_capture_thread_equal(qt, captures):
    """Both packages' CaptureThread.run on a threading.Thread over the
    SDS capture: equal frames, first and final statistics (the 1 Hz
    emission's wall-clock fields aside) and spectrum count; the status
    stream is exactly ["Stopped"]."""
    want, got = (_capture_thread_run(qt, pkg, captures / "sds.cfile")
                 for pkg in PKGS)
    for r in (want, got):
        assert r["status"] == ["Stopped"], r["status"]
        assert r["stats"] and r["spectra"] > 0
    key = [tuple(f.get(k) for k in FRAME_KEYS) for f in want["frames"]]
    assert [tuple(f.get(k) for k in FRAME_KEYS)
            for f in got["frames"]] == key
    dec = {f.get("sds_message") for f in want["frames"]
           if f.get("decrypted")}
    assert {f"[TXT] {t}" for _, _, t in SLOTS[1:]} <= dec
    assert _untimed(got["stats"][0]) == _untimed(want["stats"][0])
    assert _untimed(got["final"]) == _untimed(want["final"])
    assert got["spectra"] == want["spectra"]


def _read_wavs(d: Path, pattern: str) -> list:
    out = []
    for p in sorted(d.glob(pattern)):
        with wave.open(str(p)) as wf:
            out.append((wf.getframerate(),
                        np.frombuffer(wf.readframes(wf.getnframes()),
                                      np.int16)))
    return out


def _gui_run(qt, pkg: str, capture: Path, records: Path, voice: bool,
             monkeypatch) -> dict:
    """ModernTetraGUI.on_start with open_source redirected to the
    capture, the capture thread's run on a threading.Thread, then its
    finished signal (as QThread emits it)."""
    sources = importlib.import_module(f"{pkg}.runtime.sources")
    opened = []

    def open_source(spec, sample_rate=2.4e6, frequency=392.5e6,
                    gain="auto"):
        opened.append(spec)
        return sources.FileIQSource(capture, sample_rate=sample_rate,
                                    frequency=frequency)
    monkeypatch.setattr(sources, "open_source", open_source)
    win = _window(qt, pkg, records)
    records.mkdir(parents=True)
    if voice:
        win.rawfm_chk.setChecked(True)
        win.rec_btn.setChecked(True)
    win.on_start()
    assert opened == ["rtlsdr"] and win.thread is not None
    got = {"status": [], "audio": [], "raw": []}
    win.thread.status_update.connect(got["status"].append)
    win.thread.voice_audio.connect(got["audio"].append)
    win.thread.raw_audio.connect(got["raw"].append)
    _on_thread(win.thread.run)
    win.thread.finished.emit()
    assert win.thread is None and win.status.text() == "stopped"
    if voice:
        win.rec_btn.setChecked(False)
    got["tables"] = _tables(win)
    got["rec"] = _read_wavs(records, "rec_*.wav")
    got["rawfm"] = _read_wavs(records, "rawfm_*.wav")
    return got


@pytest.mark.parametrize("voice", [False, True], ids=["sds", "voice"])
def test_gui_start_equal(qt, captures, tmp_path, monkeypatch, voice):
    """The window's own START path over each package: equal table cells,
    voice PCM, raw FM audio and REC / raw FM WAV contents; no error."""
    cap = captures / ("voice.cfile" if voice else "sds.cfile")
    want, got = (_gui_run(qt, pkg, cap, tmp_path / pkg, voice, monkeypatch)
                 for pkg in PKGS)
    for r in (want, got):
        assert r["status"] == ["Stopped"], r["status"]
    assert want["tables"]["frames_table"]
    assert got["tables"] == want["tables"]
    for k in ("audio", "raw"):
        assert len(got[k]) == len(want[k])
        for w, g in zip(want[k], got[k]):
            np.testing.assert_array_equal(g, w)
    if voice:
        assert want["audio"] and want["raw"]
        assert len(want["rec"]) == 1 and len(want["rawfm"]) == 1
    else:
        assert not want["audio"] and not want["rec"]
    for k in ("rec", "rawfm"):
        assert len(got[k]) == len(want[k])
        for (wr, wp), (gr, gp) in zip(want[k], got[k]):
            assert wr == gr
            np.testing.assert_array_equal(gp, wp)


def test_qt_main_without_pyqt(monkeypatch):
    """Without PyQt6 the port's main prints the reference's message,
    naming the port's dashboard, and returns 1."""
    for name in QT_MODULES:
        monkeypatch.setitem(sys.modules, name, None)
    del sys.modules["tetraear_tpu_torch.ui.qt"]
    qt = importlib.import_module("tetraear_tpu_torch.ui.qt")
    assert not qt.QT_AVAILABLE
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert qt.main(["--device", "cpu"]) == 1
    assert ("python -m tetraear_tpu_torch.ui.dashboard --source synthetic"
            in buf.getvalue())


def test_kernel_build_once_across_threads(tmp_path, monkeypatch):
    """The GUI's capture thread builds the kernel library at first use:
    four threads that reach cuda_kernels.build() together share one
    build (nvcc stood in for by a fake that takes a while): each source
    is compiled once, linked once, and every thread gets the same
    library."""
    import time
    from unittest import mock
    from tetraear_tpu_torch.dsp import cuda_kernels as ck

    calls = {"compile": [], "link": 0}

    class Popen:
        def __init__(self, cmd, **kw):
            calls["compile"].append(cmd[-1])
            time.sleep(0.2)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return ("", None)

    def run(cmd, **kw):
        calls["link"] += 1
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return mock.Mock(returncode=0, stdout="", stderr="")

    fake = mock.Mock(Popen=Popen, run=run, PIPE=-1, STDOUT=-2)
    monkeypatch.setattr(ck, "subprocess", fake)
    monkeypatch.setattr(ck, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ck, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "build_info", {})
    monkeypatch.setattr(ck.ctypes, "CDLL", lambda path: mock.MagicMock())
    barrier, libs = threading.Barrier(4), []

    def first_use():
        barrier.wait()
        libs.append(ck.build())
    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    units = [n for n in ck._SOURCES if n.endswith(".cu")]
    assert sorted(calls["compile"]) == sorted(str(ck._CSRC / n)
                                              for n in units)
    assert calls["link"] == 1
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == [
        Path(ck.build_info["path"]).name]
