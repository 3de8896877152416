"""PyQt6 desktop GUI (optional; requires PyQt6 + a display).

Equivalent of the reference main window (tetraear/ui/modern.py:2511-5331):
control panel (frequency/gain/presets, START/STOP, auto-decrypt), live
spectrum + waterfall with click-to-tune, tabs for Frames / Calls / Groups /
Users / Stats, and a capture thread that feeds the streaming Pipeline and
marshals events to the GUI thread via queued signals
(modern.py:1787-1794 pattern).

All display math (colormap, peak search, calibration) lives in
tetraear_tpu_torch.ui.spectrum so it is shared with the curses dashboard and
unit-testable without Qt.

The window runs the pipeline on the CUDA card unless it is given
``device="cpu"`` (``--device cpu``); without a card it refuses to be
built, so nothing falls back to the CPU.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

try:
    from PyQt6.QtCore import Qt, QThread, pyqtSignal
    from PyQt6.QtGui import QImage, QPixmap
    from PyQt6.QtWidgets import (QApplication, QCheckBox, QComboBox,
                                 QDoubleSpinBox, QFileDialog, QHBoxLayout,
                                 QLabel, QLineEdit, QMainWindow,
                                 QPushButton, QSlider, QTableWidget,
                                 QTableWidgetItem, QTabWidget, QVBoxLayout,
                                 QWidget)
    QT_AVAILABLE = True
except ImportError:  # pragma: no cover - headless environments
    QT_AVAILABLE = False
    QThread = object

from tetraear_tpu_torch.ui import spectrum as spec_mod

DARK_QSS = """
QMainWindow, QWidget { background: #09090b; color: #fafafa; }
QPushButton { background: #18181b; border: 1px solid #27272a;
              border-radius: 6px; padding: 6px 14px; }
QPushButton:hover { background: #27272a; }
QPushButton#start { background: #166534; }
QPushButton#stop { background: #7f1d1d; }
QTableWidget { background: #09090b; gridline-color: #27272a; }
QHeaderView::section { background: #18181b; border: 0; padding: 4px; }
QTabBar::tab { background: #18181b; padding: 6px 16px; }
QTabBar::tab:selected { background: #27272a; }
"""

if QT_AVAILABLE:

    class CaptureThread(QThread):
        """Worker thread: source -> Pipeline; queued signals to the GUI
        (modern.py:1784-2256 analogue)."""

        frame_decoded = pyqtSignal(dict)
        spectrum_update = pyqtSignal(object)
        voice_audio = pyqtSignal(object)
        raw_audio = pyqtSignal(object)
        status_update = pyqtSignal(str)
        stats_update = pyqtSignal(dict)

        def __init__(self, config, source):
            super().__init__()
            self.config = config
            self.source = source
            self.pipeline = None        # live handle for runtime key load
            self._running = False

        def run(self):
            import time as _time
            from tetraear_tpu_torch.api import Pipeline
            self._running = True
            pipe = Pipeline(
                self.config,
                on_frame=self.frame_decoded.emit,
                on_spectrum=self.spectrum_update.emit,
                on_audio=self.voice_audio.emit,
                on_status=self.status_update.emit,
                on_raw_audio=self.raw_audio.emit)
            self.pipeline = pipe
            last_stats = 0.0
            try:
                with self.source:
                    while self._running:
                        block = self.source.read_samples(pipe.block_len)
                        if len(block) < pipe.block_len:
                            break
                        pipe.process_block(block)
                        now = _time.time()
                        if now - last_stats >= 1.0:
                            last_stats = now
                            self.stats_update.emit(pipe.stats.as_dict())
            except Exception as e:
                self.status_update.emit(f"error: {e}")
            self.pipeline = None
            self.status_update.emit("Stopped")

        def stop(self):
            self._running = False

    class WaterfallWidget(QLabel):
        """Spectrum-over-time display with click-to-tune
        (modern.py:649-1362 analogue)."""

        clicked_freq = pyqtSignal(float)
        peak_info = pyqtSignal(dict)

        def __init__(self, fs: float, width: int = 800, height: int = 200):
            super().__init__()
            self.fs = fs
            self.buf = spec_mod.WaterfallBuffer(width, height)
            self.denoise = spec_mod.SpectrumDenoiser()
            self.setMinimumSize(width, height)
            # spectrum sliders state (modern.py:3792-3887): auto mode
            # tracks auto_calibrate; manual mode uses the slider values
            self.auto_cal = True
            self.zoom = 1.0
            self.manual_floor_db = -90.0
            self.manual_ceiling_db = -20.0
            self.last_cal = {"floor_db": -90.0, "ceiling_db": -20.0}
            self.last_power = None      # displayed slice (zoomed)

        def push(self, power_db):
            p = self.denoise(np.asarray(power_db))
            p = spec_mod.zoom_slice(p, self.zoom)
            self.last_power = p
            if self.auto_cal:
                cal = spec_mod.auto_calibrate(p)
                self.last_cal = cal
                self.buf.floor_db = cal["floor_db"]
                self.buf.ceiling_db = cal["ceiling_db"]
            else:
                self.buf.floor_db = self.manual_floor_db
                self.buf.ceiling_db = self.manual_ceiling_db
            self.buf.push(p)
            rows = np.ascontiguousarray(self.buf.rows)
            img = QImage(rows.data, rows.shape[1], rows.shape[0],
                         3 * rows.shape[1], QImage.Format.Format_RGB888)
            self.setPixmap(QPixmap.fromImage(img))

        def mousePressEvent(self, ev):
            x = ev.position().x() / max(self.width(), 1)
            if (ev.modifiers() & Qt.KeyboardModifier.ControlModifier
                    and self.last_power is not None
                    and len(self.last_power) >= 16):
                # Ctrl-click precision tune (modern.py:698-772): snap to
                # the sub-bin-interpolated peak in a window around the
                # click, and report its -6 dB bandwidth (774-857)
                p = np.asarray(self.last_power)
                n = len(p)
                k = int(np.clip(round(x * n), 0, n - 1))
                half = max(4, n // 32)
                lo = max(0, k - half)
                win = p[lo:min(n, k + half)]
                fs_v = self.fs / self.zoom
                bin_hz = fs_v / n
                fs_w = bin_hz * len(win)   # keeps the window's bin width
                pk = spec_mod.find_peak(win, fs_w)
                freq = (pk["freq_offset_hz"]
                        + (lo + len(win) / 2 - n / 2) * bin_hz)
                bw = spec_mod.estimate_bandwidth(win, fs_w)
                self.peak_info.emit({"freq_offset_hz": freq,
                                     "power_db": pk["power_db"],
                                     "bandwidth_hz": bw})
                self.clicked_freq.emit(freq)
                return
            self.clicked_freq.emit((x - 0.5) * self.fs / self.zoom)

    class ScannerDialog(QWidget):
        """Threaded frequency-scan dialog (modern.py:1363-1782 analogue):
        presets, live result table, double-click to tune."""

        tuned = pyqtSignal(float)

        def __init__(self, make_source, sample_rate: float = 2.4e6):
            super().__init__()
            self.make_source = make_source
            self.sample_rate = sample_rate
            self.setWindowTitle("TETRA Scanner")
            lay = QVBoxLayout(self)
            row = QHBoxLayout()
            self.preset = QComboBox()
            for name, lo, hi in (("Poland primary", 390.0, 395.0),
                                 ("Poland emergency", 380.0, 385.0),
                                 ("EU civil", 410.0, 430.0)):
                self.preset.addItem(f"{name} ({lo}-{hi} MHz)", (lo, hi))
            row.addWidget(self.preset)
            self.go = QPushButton("Scan")
            self.go.clicked.connect(self.start_scan)
            row.addWidget(self.go)
            self.progress = QLabel("")
            row.addWidget(self.progress)
            lay.addLayout(row)
            self.table = QTableWidget(0, 4)
            self.table.setHorizontalHeaderLabels(
                ["MHz", "Power dB", "Confidence", "Sync"])
            self.table.cellDoubleClicked.connect(self._tune)
            lay.addWidget(self.table)
            self._thread = None

        def start_scan(self):
            import threading
            lo, hi = self.preset.currentData()
            self.table.setRowCount(0)
            self.progress.setText("scanning...")

            def run():
                from tetraear_tpu_torch.scan.scanner import FrequencyScanner
                src = self.make_source()
                if not src.open():
                    return
                try:
                    sc = FrequencyScanner(src,
                                          sample_rate=self.sample_rate)
                    for ch in sc.scan_range(lo * 1e6, hi * 1e6):
                        self._add_row(ch)
                finally:
                    src.close()

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()

        def _add_row(self, ch: dict):
            r = self.table.rowCount()
            self.table.insertRow(r)
            self.table.setItem(r, 0, QTableWidgetItem(
                f"{ch['frequency_mhz']:.4f}"))
            self.table.setItem(r, 1, QTableWidgetItem(
                f"{ch['power_db']:.1f}"))
            self.table.setItem(r, 2, QTableWidgetItem(
                f"{ch['confidence']:.2f}"))
            self.table.setItem(r, 3, QTableWidgetItem(
                "yes" if ch.get("sync_detected") else "no"))

        def _tune(self, row, _col):
            item = self.table.item(row, 0)
            if item:
                self.tuned.emit(float(item.text()) * 1e6)

    class SettingsDialog(QWidget):
        """Settings editor (modern.py settings dialog analogue):
        records directory, MP3 export, silent-file retention — persisted
        through SettingsManager and applied to the live recorder."""

        def __init__(self, settings, recorder=None):
            super().__init__()
            self.settings = settings
            self.recorder = recorder
            lay = QVBoxLayout(self)
            row = QHBoxLayout()
            row.addWidget(QLabel("Records dir"))
            self.records_edit = QLineEdit(
                str(settings.get("records_dir") or "records"))
            row.addWidget(self.records_edit)
            lay.addLayout(row)
            self.mp3_chk = QCheckBox("Export MP3 after recording")
            self.mp3_chk.setChecked(bool(settings.get("export_mp3",
                                                      False)))
            lay.addWidget(self.mp3_chk)
            self.silence_chk = QCheckBox("Keep silent recordings")
            self.silence_chk.setChecked(bool(settings.get("save_silence",
                                                          False)))
            lay.addWidget(self.silence_chk)
            row2 = QHBoxLayout()
            row2.addWidget(QLabel("Max recordings (0 = unlimited)"))
            self.maxrec_edit = QLineEdit(
                str(settings.get("max_recordings", 0)))
            row2.addWidget(self.maxrec_edit)
            lay.addLayout(row2)
            row3 = QHBoxLayout()
            row3.addWidget(QLabel("Log level"))
            self.loglevel_box = QComboBox()
            for lvl in ("DEBUG", "INFO", "WARNING", "ERROR"):
                self.loglevel_box.addItem(lvl)
            cur = str(settings.get("log_level", "INFO"))
            for i in range(self.loglevel_box.count()):
                if self.loglevel_box.itemText(i) == cur:
                    self.loglevel_box.setCurrentIndex(i)
            row3.addWidget(self.loglevel_box)
            lay.addLayout(row3)
            self.save_btn = QPushButton("Save")
            self.save_btn.clicked.connect(self.on_save)
            lay.addWidget(self.save_btn)

        def on_save(self):
            self.settings.set("records_dir", self.records_edit.text())
            self.settings.set("export_mp3", self.mp3_chk.isChecked())
            self.settings.set("save_silence", self.silence_chk.isChecked())
            try:
                maxrec = max(0, int(self.maxrec_edit.text() or 0))
            except ValueError:
                # bad input: KEEP the previous value (coercing to 0
                # would silently disable pruning); the persisted value
                # is untrusted too
                try:
                    maxrec = max(0, int(self.settings.get(
                        "max_recordings", 0)))
                except (TypeError, ValueError):
                    maxrec = 0
                self.maxrec_edit.setText(str(maxrec))
            self.settings.set("max_recordings", maxrec)
            level = self.loglevel_box.currentText()
            self.settings.set("log_level", level)
            logging.getLogger("tetraear_tpu_torch").setLevel(level)
            if self.recorder is not None:
                from pathlib import Path
                self.recorder.records_dir = Path(self.records_edit.text())
                self.recorder.export_mp3 = self.mp3_chk.isChecked()
                self.recorder.delete_silent = not self.silence_chk.isChecked()
                self.recorder.max_recordings = maxrec or None
            self.close()

    class ModernTetraGUI(QMainWindow):
        """Main window (modern.py:2511 analogue)."""

        def __init__(self, settings=None, device=None):
            super().__init__()
            from tetraear_tpu_torch.device import resolve
            resolve(device)             # no card and no "cpu": raise here
            self.device = device
            from tetraear_tpu_torch.frame.sdsstore import SDSMessageStore
            from tetraear_tpu_torch.ui.filters import FrameFilter
            from tetraear_tpu_torch.ui.recording import RecordingController
            from tetraear_tpu_torch.utils.settings import (
                FrequencyManager, SettingsManager)
            self.settings = settings or SettingsManager()
            self.freqs = FrequencyManager()
            self.thread = None
            self.frame_filter = FrameFilter()
            self.sds_store = SDSMessageStore()
            self.recorder = RecordingController(
                records_dir=self.settings.get("records_dir") or "records",
                export_mp3=bool(self.settings.get("export_mp3", False)),
                delete_silent=not self.settings.get("save_silence", False),
                max_recordings=int(self.settings.get("max_recordings", 0))
                or None)
            from tetraear_tpu_torch.ui.status import TetraStatusTracker
            self.status_tracker = TetraStatusTracker()
            self.encryption_keys: list[str] = []
            self.rawfm_recorder = None
            self._all_frames = []
            # apply the persisted log level at startup (the settings
            # dialog writes it; parity with the reference's behavior) —
            # persisted data is untrusted, fall back to INFO
            lvl = str(self.settings.get("log_level", "INFO")).upper()
            if lvl not in ("DEBUG", "INFO", "WARNING", "ERROR"):
                lvl = "INFO"
            logging.getLogger("tetraear_tpu_torch").setLevel(lvl)
            self.setWindowTitle("tetraear-tpu")
            self.setStyleSheet(DARK_QSS)
            self._build_ui()
            self.calls = {}
            self.groups = {}
            self.users = {}

        def _build_ui(self):
            root = QWidget()
            layout = QVBoxLayout(root)

            # control panel
            panel = QHBoxLayout()
            self.freq_spin = QDoubleSpinBox()
            self.freq_spin.setRange(30.0, 1700.0)
            self.freq_spin.setDecimals(4)
            self.freq_spin.setValue(
                self.settings.get("last_frequency", 392.5e6) / 1e6)
            self.freq_spin.setSuffix(" MHz")
            panel.addWidget(self.freq_spin)
            self.preset_box = QComboBox()
            for p in self.freqs.frequencies:
                self.preset_box.addItem(
                    f"{p['name']} ({p['frequency'] / 1e6:.4f})",
                    p["frequency"])
            self.preset_box.currentIndexChanged.connect(self._preset)
            panel.addWidget(self.preset_box)
            self.auto_decrypt = QCheckBox("Auto-Decrypt")
            self.auto_decrypt.setChecked(True)
            panel.addWidget(self.auto_decrypt)
            self.start_btn = QPushButton("START")
            self.start_btn.setObjectName("start")
            self.start_btn.clicked.connect(self.on_start)
            panel.addWidget(self.start_btn)
            self.stop_btn = QPushButton("STOP")
            self.stop_btn.setObjectName("stop")
            self.stop_btn.clicked.connect(self.on_stop)
            panel.addWidget(self.stop_btn)
            self.rec_btn = QPushButton("REC")
            self.rec_btn.setCheckable(True)
            self.rec_btn.toggled.connect(self.on_rec_toggled)
            panel.addWidget(self.rec_btn)
            self.monitor_chk = QCheckBox("Monitor Audio")
            self.monitor_chk.toggled.connect(
                lambda on: self.recorder.set_monitor(on))
            panel.addWidget(self.monitor_chk)
            self.rawfm_chk = QCheckBox("Raw FM")
            self.rawfm_chk.toggled.connect(self.on_rawfm_toggled)
            panel.addWidget(self.rawfm_chk)
            self.load_keys_btn = QPushButton("Load Keys")
            self.load_keys_btn.clicked.connect(lambda: self.on_load_keys())
            panel.addWidget(self.load_keys_btn)
            panel.addStretch(1)
            self.status = QLabel("idle")
            panel.addWidget(self.status)
            layout.addLayout(panel)

            # always-visible status strip (modern.py:5221-5302): TETRA
            # detection state + live sync/CRC/decrypt rates + the
            # Ctrl-click peak readout
            strip = QHBoxLayout()
            self.tetra_status = QLabel("No TETRA Signal")
            strip.addWidget(self.tetra_status)
            self.rate_label = QLabel("")
            strip.addWidget(self.rate_label)
            self.peak_label = QLabel("")
            strip.addWidget(self.peak_label)
            strip.addStretch(1)
            layout.addLayout(strip)

            # gain + sample-rate controls (modern.py:2817-3167)
            hw = QHBoxLayout()
            hw.addWidget(QLabel("Gain"))
            self.gain_slider = QSlider(Qt.Orientation.Horizontal)
            self.gain_slider.setRange(0, 50)
            gain = self.settings.get("gain", "auto")
            self.gain_auto = QCheckBox("auto")
            self.gain_auto.setChecked(gain == "auto")
            self.gain_slider.setValue(
                0 if gain == "auto" else int(float(gain)))
            self.gain_slider.valueChanged.connect(self.on_gain_changed)
            self.gain_auto.toggled.connect(
                lambda _on: self.on_gain_changed(self.gain_slider.value()))
            hw.addWidget(self.gain_slider)
            hw.addWidget(self.gain_auto)
            self.gain_label = QLabel(str(gain))
            hw.addWidget(self.gain_label)
            hw.addWidget(QLabel("Rate"))
            self.rate_box = QComboBox()
            from tetraear_tpu_torch.runtime.sources import RTL_VALID_RATES
            for r in RTL_VALID_RATES:
                self.rate_box.addItem(f"{r / 1e6:.3f} Msps", r)
            cur = self.settings.get("sample_rate", 2.4e6)
            for i in range(self.rate_box.count()):
                if abs(self.rate_box.itemData(i) - cur) < 1:
                    self.rate_box.setCurrentIndex(i)
            self.rate_box.currentIndexChanged.connect(self.on_rate_changed)
            hw.addWidget(self.rate_box)
            hw.addStretch(1)
            layout.addLayout(hw)

            self.waterfall = WaterfallWidget(
                fs=self.settings.get("sample_rate", 2.4e6))
            self.waterfall.clicked_freq.connect(self._tune_offset)
            self.waterfall.peak_info.connect(self._show_peak)
            layout.addWidget(self.waterfall)

            # spectrum zoom / top / bottom / threshold sliders + auto
            # calibration toggle (modern.py:3792-3887)
            sp = QHBoxLayout()
            sp.addWidget(QLabel("Zoom"))
            self.zoom_slider = QSlider(Qt.Orientation.Horizontal)
            self.zoom_slider.setRange(10, 100)       # zoom x1.0 .. x10.0
            self.zoom_slider.setValue(10)
            self.zoom_slider.valueChanged.connect(self._spectrum_changed)
            sp.addWidget(self.zoom_slider)
            sp.addWidget(QLabel("Top"))
            self.top_slider = QSlider(Qt.Orientation.Horizontal)
            self.top_slider.setRange(-100, 0)
            self.top_slider.setValue(-20)
            self.top_slider.valueChanged.connect(self._spectrum_changed)
            sp.addWidget(self.top_slider)
            sp.addWidget(QLabel("Bottom"))
            self.bottom_slider = QSlider(Qt.Orientation.Horizontal)
            self.bottom_slider.setRange(-140, -20)
            self.bottom_slider.setValue(-90)
            self.bottom_slider.valueChanged.connect(self._spectrum_changed)
            sp.addWidget(self.bottom_slider)
            sp.addWidget(QLabel("Threshold"))
            self.threshold_slider = QSlider(Qt.Orientation.Horizontal)
            self.threshold_slider.setRange(-100, -30)
            self.threshold_slider.setValue(int(self.settings.get(
                "peak_threshold_db", -70)))
            self.threshold_slider.valueChanged.connect(
                self._spectrum_changed)
            sp.addWidget(self.threshold_slider)
            self.auto_sliders = QCheckBox("Auto")
            self.auto_sliders.setChecked(True)
            self.auto_sliders.toggled.connect(
                lambda _on: self._spectrum_changed())
            sp.addWidget(self.auto_sliders)
            self.settings_btn = QPushButton("Settings")
            self.settings_btn.clicked.connect(self.on_settings)
            sp.addWidget(self.settings_btn)
            sp.addStretch(1)
            layout.addLayout(sp)

            # frames-table filters (modern.py:4326-4473)
            from tetraear_tpu_torch.ui.filters import (
                ENC_CHOICES, READ_CHOICES, TYPE_CHOICES)
            fl = QHBoxLayout()
            self.type_filter = QComboBox()
            self.type_filter.addItems(list(TYPE_CHOICES))
            self.enc_filter = QComboBox()
            self.enc_filter.addItems(list(ENC_CHOICES))
            self.read_filter = QComboBox()
            self.read_filter.addItems(list(READ_CHOICES))
            for b in (self.type_filter, self.enc_filter, self.read_filter):
                b.currentIndexChanged.connect(self._filters_changed)
                fl.addWidget(b)
            fl.addStretch(1)
            layout.addLayout(fl)

            # tabs
            self.tabs = QTabWidget()
            self.frames_table = self._table(
                ["#", "Type", "Carrier", "CRC", "Enc", "TG", "SSI",
                 "Country", "Message"])
            self.calls_table = self._table(
                ["TG", "Source", "Dest", "Type", "Priority", "Enc",
                 "Frames"])
            self.groups_table = self._table(["TG", "Frames", "Last seen"])
            self.users_table = self._table(["SSI", "Frames", "Last seen"])
            self.sds_table = self._table(
                ["Source", "TG", "Carrier", "Flags", "Message"])
            self.stats_label = QLabel("")
            stats_w = QWidget()
            QVBoxLayout(stats_w).addWidget(self.stats_label)
            self.tabs.addTab(self.frames_table, "Frames")
            self.tabs.addTab(self.calls_table, "Calls")
            self.tabs.addTab(self.groups_table, "Groups")
            self.tabs.addTab(self.users_table, "Users")
            self.tabs.addTab(self.sds_table, "SDS")
            self.tabs.addTab(stats_w, "Stats")
            layout.addWidget(self.tabs)
            self.setCentralWidget(root)

        @staticmethod
        def _table(cols):
            t = QTableWidget(0, len(cols))
            t.setHorizontalHeaderLabels(cols)
            return t

        def _preset(self, idx):
            f = self.preset_box.currentData()
            if f:
                self.freq_spin.setValue(f / 1e6)

        # -- controls -----------------------------------------------------

        def on_rec_toggled(self, on: bool):
            """REC button (modern.py:4049-4194): continuous WAV with
            silent-delete + optional MP3 on stop."""
            if on:
                path = self.recorder.start()
                self.status.setText(f"recording {path.name}")
            else:
                kept = self.recorder.stop()
                self.status.setText(
                    f"saved {kept.name}" if kept else "recording silent"
                    " — discarded")

        def on_gain_changed(self, value: int):
            gain = "auto" if self.gain_auto.isChecked() else float(value)
            self.gain_label.setText(str(gain))
            self.settings.set("gain", gain)
            src = getattr(self.thread, "source", None)
            if src is not None and hasattr(src, "set_gain"):
                try:
                    src.set_gain(gain)
                except Exception as e:
                    logger.debug("live gain change failed: %s", e)

        def on_rate_changed(self, _idx: int):
            rate = self.rate_box.currentData()
            if rate:
                self.settings.set("sample_rate", float(rate))
                self.status.setText(
                    f"rate {rate / 1e6:.3f} Msps (takes effect on START)")

        def _filters_changed(self, _idx: int = 0):
            """Re-apply the dropdowns to the retained frame history."""
            self.frame_filter.type_choice = self.type_filter.currentText()
            self.frame_filter.enc_choice = self.enc_filter.currentText()
            self.frame_filter.read_choice = self.read_filter.currentText()
            self.frames_table.setRowCount(0)
            for f in self._all_frames:
                if self.frame_filter.accepts(f):
                    self._append_frame_row(f)

        def _tune_offset(self, offset_hz):
            self.freq_spin.setValue(self.freq_spin.value() + offset_hz / 1e6)

        def _spectrum_changed(self, _v: int = 0):
            """Apply the zoom/top/bottom/threshold sliders + auto toggle
            (modern.py:3792-3887): auto mode keeps auto_calibrate and
            reflects its result back into the sliders; manual mode
            drives the waterfall range from the sliders."""
            w = self.waterfall
            w.zoom = self.zoom_slider.value() / 10.0
            auto = self.auto_sliders.isChecked()
            w.auto_cal = auto
            if auto:
                cal = w.last_cal
                self.top_slider.setValue(int(cal["ceiling_db"]))
                self.bottom_slider.setValue(int(cal["floor_db"]))
            else:
                w.manual_ceiling_db = float(self.top_slider.value())
                w.manual_floor_db = float(self.bottom_slider.value())
            thr = float(self.threshold_slider.value())
            # SettingsManager.set writes the JSON file; only touch disk
            # when the threshold actually changed (slider drags fire
            # per tick, and the auto-mode setValue reflection re-enters)
            if thr != self.settings.get("peak_threshold_db", None):
                self.settings.set("peak_threshold_db", thr)

        def on_settings(self):
            self._settings_dialog = SettingsDialog(self.settings,
                                                   self.recorder)
            self._settings_dialog.show()

        def on_load_keys(self, path=None):
            """Load-Keys button (modern.py:2918-2922, 3987-4021): pick a
            key file, apply to the LIVE pipeline via Pipeline.set_keys,
            and keep the keys for future captures."""
            from tetraear_tpu_torch.utils.keyload import load_key_file
            if path is None:
                path, _filt = QFileDialog.getOpenFileName(
                    self, "Load Keys", "",
                    "Key Files (*.txt);;All Files (*.*)")
            if not path:
                return
            try:
                keys = load_key_file(path)
            except OSError as e:
                self.status.setText(f"key load failed: {e}")
                return
            if not keys:
                self.status.setText("no valid keys in file")
                return
            self.encryption_keys = keys
            pipe = getattr(self.thread, "pipeline", None)
            if pipe is not None:
                pipe.set_keys(keys)
            self.status.setText(f"loaded {len(keys)} encryption keys")

        def on_rawfm_toggled(self, on: bool):
            """Raw-FM monitoring checkbox (modern.py:2040-2061): FM
            discriminator audio from the Pipeline streamed to a 48 kHz
            WAV; live-togglable (Pipeline checks config.raw_fm per
            block)."""
            pipe = getattr(self.thread, "pipeline", None)
            if pipe is not None:
                pipe.config.raw_fm = on
            rec = self.rawfm_recorder
            if rec is None:
                return
            if on:
                path = rec.start()
                self.status.setText(f"raw FM -> {path.name}")
            else:
                path = rec.stop()
                if path is not None:
                    self.status.setText(f"raw FM saved {path.name}")

        def on_stats(self, stats: dict):
            """1 Hz pipeline stats -> the status strip."""
            st = self.status_tracker.evaluate(stats)
            self.tetra_status.setText(st["text"])
            self.rate_label.setText(
                f"Sync {st['sync_rate']:.0%} | CRC {st['crc_rate']:.0%}"
                f" | Decrypt {st['decrypt_rate']:.0%}")

        def _show_peak(self, info: dict):
            self.peak_label.setText(
                f"peak {info['freq_offset_hz'] / 1e3:+.1f} kHz  "
                f"{info['power_db']:.1f} dB  "
                f"bw {info['bandwidth_hz'] / 1e3:.1f} kHz")

        def on_start(self):
            from tetraear_tpu_torch.api import PipelineConfig
            from tetraear_tpu_torch.runtime.sources import open_source
            if self.thread is not None:
                return
            freq = self.freq_spin.value() * 1e6
            self.settings.set("last_frequency", freq)
            cfg = PipelineConfig(
                sample_rate=self.settings.get("sample_rate", 2.4e6),
                frequency=freq,
                auto_decrypt=self.auto_decrypt.isChecked(),
                keys=tuple(self.encryption_keys),
                raw_fm=self.rawfm_chk.isChecked(),
                device=self.device)
            source = open_source("rtlsdr",
                                 sample_rate=cfg.sample_rate,
                                 frequency=freq,
                                 gain=self.settings.get("gain", "auto"))
            from tetraear_tpu_torch.frame.aggregator import CallAggregator
            from tetraear_tpu_torch.ui.recording import RawFMRecorder
            self.aggregator = CallAggregator()
            self.rawfm_recorder = RawFMRecorder(
                self.recorder.records_dir, fs=cfg.sample_rate)
            if cfg.raw_fm:
                self.rawfm_recorder.start()
            self.thread = CaptureThread(cfg, source)
            self.thread.frame_decoded.connect(self.on_frame)
            self.thread.spectrum_update.connect(self.waterfall.push)
            self.thread.status_update.connect(self.status.setText)
            self.thread.voice_audio.connect(self.recorder.feed)
            self.thread.raw_audio.connect(self.rawfm_recorder.feed)
            self.thread.stats_update.connect(self.on_stats)
            self.thread.finished.connect(self._thread_done)
            self.thread.start()
            self.status.setText("running")

        def on_stop(self):
            if self.thread is not None:
                self.thread.stop()

        def _thread_done(self):
            self.thread = None
            if self.rawfm_recorder is not None:
                self.rawfm_recorder.stop()
            self.status.setText("stopped")

        def _append_frame_row(self, frame: dict):
            from tetraear_tpu_torch.frame import mcc_mnc
            t = self.frames_table
            row = t.rowCount()
            t.insertRow(row)
            meta = frame.get("call_metadata") or {}
            vals = [
                str(frame.get("number", "")),
                frame.get("type_name", ""),
                str(frame.get("carrier", 0)),
                "OK" if frame.get("burst_crc") else "FAIL",
                ("DEC" if frame.get("decrypted")
                 else "ENC" if frame.get("encrypted") else "CLR"),
                str(meta.get("talkgroup_id") or ""),
                str(meta.get("source_ssi") or ""),
                (mcc_mnc.get_location_info(meta["mcc"], meta.get("mnc"))
                 if meta.get("mcc") else ""),
                frame.get("sds_message") or "",
            ]
            for c, v in enumerate(vals):
                t.setItem(row, c, QTableWidgetItem(v))
            t.scrollToBottom()

        def _refresh_sds(self):
            t = self.sds_table
            rows = self.sds_store.snapshot()
            t.setRowCount(len(rows))
            for r, m in enumerate(rows):
                vals = [str(m["source"]), str(m["talkgroup"]),
                        str(m["carrier"]), m["flags"], m["text"]]
                for c, v in enumerate(vals):
                    t.setItem(r, c, QTableWidgetItem(v))

        def on_frame(self, frame: dict):
            meta = frame.get("call_metadata") or {}
            self._all_frames.append(frame)
            if len(self._all_frames) > 2000:
                del self._all_frames[:1000]
            if self.frame_filter.accepts(frame):
                self._append_frame_row(frame)
            if self.sds_store.add_frame(frame) is not None:
                self._refresh_sds()
            # aggregate tables
            tg = meta.get("talkgroup_id")
            if tg:
                self.groups[tg] = self.groups.get(tg, 0) + 1
            ssi = meta.get("source_ssi")
            if ssi:
                self.users[ssi] = self.users.get(ssi, 0) + 1
            if getattr(self, "aggregator", None) is not None:
                self.aggregator.add_frame(frame)
                snap = self.aggregator.snapshot()
                t2 = self.calls_table
                t2.setRowCount(len(snap["active_calls"]))
                for r2, c2 in enumerate(snap["active_calls"]):
                    vals2 = [str(c2["talkgroup"]), str(c2["source_ssi"]),
                             "", c2["type"], "", 
                             "yes" if c2["encrypted"] else "no",
                             str(c2["frames"])]
                    for cc, vv in enumerate(vals2):
                        t2.setItem(r2, cc, QTableWidgetItem(vv))
            self._refresh_agg()

        def _refresh_agg(self):
            for table, data in ((self.groups_table, self.groups),
                                (self.users_table, self.users)):
                table.setRowCount(len(data))
                for r, (key, count) in enumerate(sorted(data.items())):
                    table.setItem(r, 0, QTableWidgetItem(str(key)))
                    table.setItem(r, 1, QTableWidgetItem(str(count)))


def pre_gui_scan(lo_mhz: float, hi_mhz: float, source: str = "rtlsdr",
                 sample_rate: float = 2.4e6):
    """Pre-GUI frequency scan (reference modern.py:5452-5493): sweep the
    range before the window opens and return the strongest validated
    TETRA hit's frequency in Hz (None when nothing found).  Qt-free —
    usable from any frontend."""
    from tetraear_tpu_torch.runtime.sources import open_source
    from tetraear_tpu_torch.scan.scanner import FrequencyScanner

    src = open_source(source, sample_rate=sample_rate,
                      frequency=lo_mhz * 1e6)
    try:
        sc = FrequencyScanner(src, sample_rate=sample_rate)
        found = sc.scan_range(lo_mhz * 1e6, hi_mhz * 1e6)
    finally:
        close = getattr(src, "close", None)
        if close:
            close()
    if not found:
        return None
    best = max(found, key=lambda ch: (ch.get("confidence", 0.0),
                                      ch.get("power_db", -999.0)))
    return float(best["frequency"])


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="tetraear_tpu_torch.ui.qt")
    parser.add_argument("--scan", nargs=2, type=float,
                        metavar=("START_MHZ", "STOP_MHZ"),
                        help="scan the range before opening the GUI and "
                             "tune to the best hit (modern.py:5452-5493)")
    parser.add_argument("--source", default="rtlsdr")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)")
    args, qt_args = parser.parse_known_args(argv)

    if not QT_AVAILABLE:
        print("PyQt6 is not installed; use the terminal dashboard instead:\n"
              "  python -m tetraear_tpu_torch.ui.dashboard --source synthetic")
        return 1
    app = QApplication(qt_args)
    win = ModernTetraGUI(device=args.device)
    if args.scan:
        best = pre_gui_scan(args.scan[0], args.scan[1], source=args.source)
        if best is not None:
            win.settings.set("last_frequency", best)
            win.freq_spin.setValue(best / 1e6)
    win.resize(1100, 760)
    win.show()
    return app.exec()


if __name__ == "__main__":
    raise SystemExit(main())
