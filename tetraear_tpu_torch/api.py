"""Streaming and offline decode pipeline (tetraear_tpu/api.py).

``Pipeline(PipelineConfig(...))`` is the port's entry point, for every
receive-chain configuration the JAX ``Pipeline`` accepts —
``frontend="conv"`` or ``"fft"``, ``carrier_afc`` on or off, any rate
``choose_decim`` accepts, ``sparse_hits`` on or off.  Banks the fused
back half serves (fft frontend on a 72 kHz * 2^m rate, no AFC) take it;
all others run the classic chain (dsp/backhalf.try_fused).  It runs on
the card unless ``device="cpu"`` is given.

  * ``process_block`` / ``run`` / ``frames``: the live stream, one block
    at a time, with the detection gate, spectrum callbacks, the
    capture-level AFC and source retune, and the raw FM hook
    (``listen`` in the CLI);
  * ``run_offline``: S blocks per device batch (``decode``);
  * ``save_checkpoint`` / ``load_checkpoint``: seamless restart at a
    block boundary, leaf for leaf compatible with the JAX package's;
  * ``frame_workers > 0``: the per-hit frame layer sharded over worker
    processes (frame/parallel.py);
  * encrypted frames finish with one device key search per block
    (crypto/batch.py);
  * voice (``voice=True``, the default): a block's voice candidates are
    channel-decoded in one launch of the ``viterbi_decode`` kernel
    (voice/viterbi.py) and synthesized either on the device, every voice
    carrier's frames of the block in one launch of the ``acelp_decode``
    kernel on a bank of decoder slots (``device_voice``, voice/
    speech_pool.py), or by the port's copy of the C++ codec
    (voice/codec.py, built with g++ at first use), one stateful decoder
    a carrier, on the main thread or on ``voice_threads``.
    ``device_voice=None`` (the default) reads ``TETRAEAR_DEVICE_VOICE``
    ("1" on), and without it synthesizes on the device exactly when the
    pipeline runs on the card.
"""

from __future__ import annotations

import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tetraear_tpu_torch.crypto.tea import TetraKeyManager
from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
from tetraear_tpu_torch.frame.aggregator import CallAggregator
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
from tetraear_tpu_torch.frame.decoder import TetraDecoder
from tetraear_tpu_torch.frame.structure import FrameStructureTracker
from tetraear_tpu_torch.frame.validator import TetraSignalValidator
from tetraear_tpu_torch.runtime import profiling as prof
from tetraear_tpu_torch.runtime.stream import DecodeRunner

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    sample_rate: float = 2.4e6
    frequency: float = 392.5e6          # display/centre frequency
    carrier_offsets_hz: tuple = (0.0,)  # channels to demodulate
    block_len: int = 131_072            # a request the conv frontend
                                        # rounds to its granularity; the
                                        # fft frontend fixes its own
    auto_decrypt: bool = True
    keys: tuple = ()
    key_file: str | None = None
    expected_mcc: int | None = None
    validate: bool = True
    records_dir: str | None = None      # JSONL frame log
    # signal-detection gate of process_block (modern.py:1993-1999)
    detect_gate: bool = True
    snr_threshold_db: float = 15.0
    peak_threshold_db: float = -70.0
    peak_avg_margin_db: float = 3.0
    loss_hysteresis_s: float = 0.5
    afc: bool = False                   # coarse capture-level AFC (FFT peak)
    afc_retune_hz: float = 2000.0       # retune source when |offset| exceeds
    carrier_afc: bool = True            # per-carrier d^4 tracking loop
    frontend: str = "conv"              # "fft": wideband FFT channelizer
                                        # (the fleet-scale frontend; on a
                                        # 72 kHz-family rate with
                                        # carrier_afc off it enables the
                                        # fused back half)
    fft_size: int = 2048                # detection gate's FFT
    voice: bool = True                  # voice chain: channel decode on
                                        # the card, host synthesis
    voice_threads: int = 0              # >1: synthesize voice carriers
                                        # concurrently (one pool task per
                                        # carrier)
    device_voice: bool | None = None    # synthesize speech on the device
                                        # (None: TETRAEAR_DEVICE_VOICE,
                                        # else on exactly on the card)
    device_voice_slots: int = 256       # device decoder states; carriers
                                        # beyond it are LRU-evicted
    device_voice_mesh: object = None    # runtime.sharding.Mesh: shard the
                                        # voice slot bank over its first
                                        # axis's devices (bit-identical
                                        # PCM at any mesh size; slots
                                        # must divide by the axis size)
    frame_workers: int = 0              # >0: shard the per-hit frame layer
                                        # over worker processes
                                        # (frame.parallel)
    raw_fm: bool = False                # FM-demod raw audio monitoring
    device_scan: bool = True            # process_block: the sync/CRC scan
                                        # in the device block step; False
                                        # = bank.step + the frame layer's
                                        # own scan (batch.process)
    sparse_hits: bool = True            # fetch packed top-K hit keys
                                        # instead of the dense verdict
                                        # planes; False = the dense-plane
                                        # oracle path
    device: str | None = None           # None: the card; "cpu" runs the
                                        # kernels' plain versions


@dataclass
class PipelineStats:
    blocks: int = 0
    samples: int = 0
    frames: int = 0
    valid_frames: int = 0
    crc_pass: int = 0
    encrypted: int = 0
    decrypted: int = 0
    voice_frames: int = 0
    stolen_frames: int = 0
    sds_messages: int = 0
    signal_present: bool = False
    afc_offset_hz: float = 0.0
    started_at: float = field(default_factory=time.time)

    def as_dict(self) -> dict:
        d = self.__dict__.copy()
        dur = max(time.time() - d.pop("started_at"), 1e-9)
        d["uptime_s"] = dur
        d["samples_per_s"] = self.samples / dur
        d["frames_per_s"] = self.frames / dur
        return d


class Pipeline:
    """Streaming and offline demod/decode engine over any IQSource."""

    def __init__(self, config: PipelineConfig, on_frame=None,
                 on_spectrum=None, on_audio=None, on_status=None,
                 on_raw_audio=None):
        self.config = config
        self.on_frame = on_frame
        self.on_spectrum = on_spectrum
        self.on_audio = on_audio
        self.on_status = on_status
        self.on_raw_audio = on_raw_audio
        self._fm_prev = 1.0 + 0j
        self.device = resolve(config.device)

        # Round block length down to the demod granularity.
        probe = CarrierBankDemod(fs=config.sample_rate, freqs_hz=[0.0],
                                 frontend=config.frontend)
        if config.frontend == "fft":
            # the FFT channelizer's overlap-save geometry fixes the
            # block length (nfft - overlap); config.block_len is a
            # request the conv frontend rounds, not a contract
            self.block_len = probe.block_len
        else:
            gran = probe.granularity
            self.block_len = max(gran, (config.block_len // gran) * gran)
        self.bank = CarrierBankDemod(
            fs=config.sample_rate, freqs_hz=config.carrier_offsets_hz,
            block_len=self.block_len, afc=config.carrier_afc,
            frontend=config.frontend)
        self.n_carriers = self.bank.n_carriers

        if config.frame_workers > 0:
            # per-carrier decoder state lives in the worker processes
            from tetraear_tpu_torch.frame.parallel import ShardedFrameLayer
            self.decoders = []
            self.batch = ShardedFrameLayer(
                self.n_carriers, n_workers=config.frame_workers,
                key_file=config.key_file,
                auto_decrypt=config.auto_decrypt, keys=config.keys,
                device=self.device)
        else:
            key_manager = None
            if config.key_file:
                key_manager = TetraKeyManager()
                key_manager.load_key_file(config.key_file)
            self.decoders = [TetraDecoder(key_manager=key_manager,
                                          auto_decrypt=config.auto_decrypt)
                             for _ in range(self.n_carriers)]
            for d in self.decoders:
                if config.keys:
                    d.set_keys(list(config.keys))
            self.batch = BatchedFrameDecoder(self.n_carriers,
                                             decoders=self.decoders,
                                             device=self.device)
        # the runner picks the back half (backhalf.try_fused); its step is
        # process_block's device step and run_offline's batched one
        self._device_scan = bool(config.device_scan)
        self.voice = None
        self._voice_states: dict = {}
        self._voice_pool = None
        self._voice_device = None
        if config.voice:
            # the codec is built with g++ here; a failed build raises
            from tetraear_tpu_torch import native
            vp = native.codec().VoiceProcessor()
            self.voice = vp
            # the probe doubles as carrier 0's decoder state
            self._voice_states[0] = vp
            if config.voice_threads > 1:
                self._voice_pool = ThreadPoolExecutor(
                    max_workers=int(config.voice_threads),
                    thread_name_prefix="voice-synth")
        device_voice = config.device_voice
        if device_voice is None:
            env = os.environ.get("TETRAEAR_DEVICE_VOICE")
            if env is not None:
                device_voice = env == "1"
            else:
                # as the reference turns it on on its accelerator: on the
                # card by default, host synthesis on the CPU
                device_voice = self.device.type == "cuda"
        else:
            device_voice = bool(device_voice)
        if self.voice is not None and device_voice:
            # on the card this builds the kernels; a failed build raises
            from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool
            self._voice_device = DeviceSpeechPool(
                slots=int(config.device_voice_slots), device=self.device,
                mesh=config.device_voice_mesh)
        self.runner = DecodeRunner(self.bank, self.batch,
                                   device=self.device,
                                   sparse=config.sparse_hits,
                                   fetch_soft=self.voice is not None)
        if self._device_scan:
            self.state = self.runner.init_state()
        else:
            # host-assembled split path: the bank's own state, and the
            # frame layer drops the first differential symbol itself
            self.state = self.bank.init_state(self.device)
            self.batch._first = True
        self.dispatches = 0
        self.validator = (TetraSignalValidator(config.expected_mcc)
                          if config.validate else None)
        self.aggregator = CallAggregator()
        self.trackers = [FrameStructureTracker()
                         for _ in range(self.n_carriers)]
        self.stats = PipelineStats()
        self._last_signal_t = 0.0
        self._afc_offset = 0.0
        self._jsonl = None
        self._records_dir = (Path(config.records_dir) if config.records_dir
                             else None)
        if self._records_dir:
            self._records_dir.mkdir(parents=True, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            self._jsonl = open(self._records_dir / f"frames_{ts}.jsonl",
                               "a", encoding="utf-8")

    def voice_for(self, carrier: int):
        """Per-carrier ACELP decoder state.  The speech decoder is
        STATEFUL (adaptive-codebook history, gain predictors, LSP
        interpolation memory carry across frames); one shared state
        would interleave concurrent calls on different carriers into
        garbage.  The reference never hits this (one carrier per
        process); a carrier bank must keep one state per carrier."""
        vp = self._voice_states.get(carrier)
        if vp is None:
            from tetraear_tpu_torch.voice.codec import VoiceProcessor
            vp = self._voice_states[carrier] = VoiceProcessor()
        return vp

    # -- detection gate ----------------------------------------------------

    def _detect_signal(self, block: np.ndarray) -> tuple:
        """FFT power gate with loss hysteresis (modern.py:1919-2012).

        Returns (signal_present, peak_offset_hz, spectrum_db)."""
        n = min(self.config.fft_size, len(block))
        seg = block[:n] * np.hanning(n)
        spec = np.fft.fftshift(np.fft.fft(seg))
        power_db = 20 * np.log10(np.abs(spec) / n + 1e-12)
        peak_db = float(power_db.max())
        avg_db = float(np.mean(power_db))
        noise_db = float(np.median(power_db))
        snr = peak_db - noise_db
        present = (snr > self.config.snr_threshold_db
                   and peak_db > self.config.peak_threshold_db
                   and peak_db - avg_db > self.config.peak_avg_margin_db)
        now = time.time()
        if present:
            self._last_signal_t = now
        elif now - self._last_signal_t < self.config.loss_hysteresis_s:
            present = True          # hysteresis against flutter
        peak_bin = int(np.argmax(power_db))
        freqs = np.fft.fftshift(
            np.fft.fftfreq(n, 1.0 / self.config.sample_rate))
        return present, float(freqs[peak_bin]), power_db

    def set_keys(self, hex_keys) -> None:
        """Runtime key load across the whole frame layer (the reference
        control panel's Load-Keys button feeding TetraDecoder.set_keys,
        modern.py:2817-3167 / decoder.py:101): host per-carrier decoders
        when they exist, the sharded worker fleet otherwise."""
        keys = [str(k).strip() for k in hex_keys if str(k).strip()]
        for d in self.decoders:
            d.set_keys(keys)
        if not self.decoders and hasattr(self.batch, "set_keys"):
            self.batch.set_keys(keys)

    # -- block processing --------------------------------------------------

    def process_block(self, block: np.ndarray) -> list:
        """Feed one IQ block; returns the list of decoded frame dicts.

        The device step is the runner's (``DecodeRunner.step``: the fused
        step or the classic chain with its carried bit tail, then the
        sparse or dense scan outputs), the same one ``run_offline``
        chains, so both give the same frames for the same capture.  With
        ``device_scan=False`` the bank's block step runs and the frame
        layer scans the assembled rows itself (``batch.process``).

        The block is the root span of the port's tracer (runtime/
        profiling): traced, each block is a record of its spans, and the
        ``launches`` counter takes the block's kernel launches; the
        ``gated`` counter takes a block the detection gate drops."""
        launches = sum(ck.launches.values())
        with prof.block():
            frames_out = self._process_block(block)
            prof.count("launches", sum(ck.launches.values()) - launches)
        return frames_out

    def _process_block(self, block: np.ndarray) -> list:
        block = np.asarray(block, np.complex64)
        if len(block) < self.block_len:
            return []
        block = block[:self.block_len]
        self.stats.blocks += 1
        self.stats.samples += len(block)

        if self.config.detect_gate or self.on_spectrum or self.config.afc:
            with prof.span("gate"):
                present, peak_off, spectrum = self._detect_signal(block)
            self.stats.signal_present = present
            if self.on_spectrum:
                self.on_spectrum(spectrum)
            if self.config.detect_gate and not present:
                prof.count("gated", 1)
                if self.on_status:
                    self.on_status("no signal")
                return []
            if self.config.afc:
                # smoothed AFC: 10% of the offset per step, +-10 kHz window
                # (modern.py:5135-5169)
                if abs(peak_off) < 10_000:
                    self._afc_offset += 0.1 * (peak_off - self._afc_offset)
                self.stats.afc_offset_hz = self._afc_offset

        if self.config.raw_fm and self.on_raw_audio is not None:
            # FM-demod raw monitoring path (modern.py:2040-2061)
            from tetraear_tpu_torch.dsp import fm
            audio, self._fm_prev = fm.fm_demod(block, self._fm_prev)
            self.on_raw_audio(audio)

        if self._device_scan:
            runner = self.runner
            ys, self.state = runner.step(runner.ingest(block[None])[0],
                                         self.state)
            frames_out = runner.frames_of(runner.fetch(ys))
        else:
            out, self.state = self.bank.step(block, self.state)
            frames_out = self.batch.process(
                out["hard"].cpu().numpy(),
                (out["soft"].cpu().numpy() if self.voice is not None
                 else None),
                out["valid"].cpu().numpy())
        self._finish_block(frames_out)
        return frames_out

    def _finish_block(self, frames: list) -> None:
        """The block-level passes after the frame layer: one batched
        channel decode, speech synthesis, then each frame through
        ``_handle_frame`` (trackers, validator, aggregator, callbacks)."""
        with prof.span("voice_prepare"):
            self._prepare_voice_batch(frames)
        with prof.span("voice_synth"):
            self._synth_voice(frames)
        with prof.span("handle_frames"):
            for f in frames:
                ci = f["carrier"]
                f["carrier_offset_hz"] = float(self.bank.freqs_hz[ci])
                f["frequency"] = self.config.frequency + float(
                    self.bank.freqs_hz[ci])
                self._handle_frame(f)

    def _handle_frame(self, frame: dict) -> None:
        ci = frame.get("carrier", 0)
        if "stream_symbol" in frame and ci < len(self.trackers):
            # 255 symbols per slot -> absolute TDMA slot index
            slot = self.trackers[ci].place_at(
                frame["stream_symbol"] // 255,
                crc_ok=bool(frame.get("burst_crc")))
            tr = self.trackers[ci]
            frame["tdma"] = {"slot": slot.slot_number,
                             "frame": slot.frame_number,
                             "multiframe": tr.current_multiframe,
                             "hyperframe": tr.current_hyperframe}
        self.stats.frames += 1
        if frame.get("burst_crc"):
            self.stats.crc_pass += 1
        if frame.get("encrypted"):
            self.stats.encrypted += 1
        if frame.get("decrypted"):
            self.stats.decrypted += 1
        if frame.get("sds_message"):
            self.stats.sds_messages += 1
        if self.validator is not None:
            ok, conf, issues = self.validator.validate_frame(frame)
            frame["valid"] = ok
            frame["validation_confidence"] = conf
            frame["validation_issues"] = issues
            if ok:
                self.stats.valid_frames += 1
        if self.voice is not None:
            self._try_voice(frame)
        self.aggregator.add_frame(frame)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(_jsonable(frame)) + "\n")
            self._jsonl.flush()
        if self.on_frame:
            self.on_frame(frame)

    # -- voice ---------------------------------------------------------------

    @staticmethod
    def _is_voice_candidate(frame: dict) -> bool:
        """MAC-FRAG/type-1, clear or successfully decrypted
        (modern.py:2088-2100)."""
        pdu_type = str((frame.get("mac_pdu") or {}).get("type", ""))
        return (("FRAG" in pdu_type or frame.get("type") == 1)
                and (not frame.get("encrypted")
                     or frame.get("decrypted")
                     or frame.get("encryption_suspected")))

    def _prepare_voice_batch(self, frames: list) -> None:
        """Channel-decode all of a block's voice candidates in ONE launch
        of the speech channel decoder (voice.viterbi: the viterbi_decode
        kernel on the card, its plain version on the CPU; bit-exact vs
        the C++ decoder); per-frame speech synthesis then runs from the
        decoded parameters (_synth_voice / _try_voice).  With fewer than
        two candidates the host C++ path decodes them: in _try_voice, or
        here in device-synthesis mode, as in the JAX package."""
        if self.voice is None:
            return
        from tetraear_tpu_torch.voice.codec import (block_soft_bits,
                                                    build_codec_block,
                                                    stolen_soft_bits)
        cands = []
        for f in frames:
            if not self._is_voice_candidate(f):
                continue
            if f.get("stolen"):
                # half-slot voice (frame stealing): the CHANNEL decode is
                # a cheap stateless host call; in device-synthesis mode
                # it must run here so the carrier's stolen frames join
                # its device state stream in order.  Otherwise it decodes
                # per-frame in _try_voice_stolen (stealing is rare).
                if self._voice_device is not None:
                    soft = f.get("soft_symbols")
                    half = None if soft is None else stolen_soft_bits(soft)
                    if half is not None:
                        params = self.voice.channel_decode_stolen(half)
                        if params is not None:
                            f["_voice_params"] = params
                continue
            soft = f.get("soft_symbols")
            if soft is None:
                continue
            block = build_codec_block(soft)
            if block is None:
                continue
            f["_voice_block"] = block
            cands.append(f)
        prof.count("voice_candidates", len(cands))
        if len(cands) < 2:
            if self._voice_device is not None:
                # device synthesis needs channel-decoded params for every
                # candidate (its speech state lives on the device; the
                # host decoder would fork the carrier's state).  One
                # candidate: stateless host channel decode.
                for f in cands:
                    params = self.voice.channel_decode(f["_voice_block"])
                    if params is not None:
                        f["_voice_params"] = params
            return
        from tetraear_tpu_torch.voice import viterbi
        softs = np.stack([block_soft_bits(f["_voice_block"])
                          for f in cands])
        prof.count("v1_rows", len(softs))
        with prof.span("v1"):
            out = viterbi.channel_decode_batch(softs, device=self.device)
        for i, f in enumerate(cands):
            params = np.zeros((2, 138), np.int16)
            params[:, 0] = 1 if out["bfi"][i] else 0
            params[:, 1:] = out["frames"][i]
            f["_voice_params"] = params

    def _synth_voice_parallel(self, frames: list) -> None:
        """Synthesize this block's voice candidates concurrently, one
        pool task per carrier (PipelineConfig.voice_threads): speech
        decoders are stateful per carrier (voice_for), so a carrier's
        frames stay sequential on its own state while different
        carriers run on pool threads — the C synthesis call releases
        the GIL (ctypes) and touches only its own decoder handle
        (voice/csrc: per-handle state, thread_local scratch).  Results
        ride in frame["_voice_audio"]; _try_voice then runs unchanged
        on the main thread (records file, stats, on_audio callbacks,
        in frame order), so output ordering and audio samples are
        identical to the sequential path (test_voice_rf)."""
        if self._voice_pool is None:
            return
        by_c: dict = {}
        halted: set = set()
        for f in frames:
            ci = f["carrier"]
            if f.get("stolen"):
                # a stolen voice candidate synthesizes INLINE on the
                # carrier's stateful decoder (_try_voice_stolen);
                # pre-synthesizing this carrier's LATER frames here
                # would reorder its decoder-state updates, so the
                # carrier's pre-synthesis stops at the first stolen
                # frame and the rest stays sequential
                if self._is_voice_candidate(f):
                    halted.add(ci)
                continue
            if "_voice_block" not in f or ci in halted:
                continue
            by_c.setdefault(ci, []).append(f)
        if len(by_c) < 2:
            return                       # nothing to overlap

        def synth(vp, fs):
            # every pre-synthesizable frame carries device-decoded
            # params (_prepare_voice_batch ran with >= 2 candidates);
            # the whole carrier is ONE foreign call, GIL released
            # throughout (codec.decode_params_many)
            return vp.decode_params_many(
                np.stack([f["_voice_params"] for f in fs]))

        # voice_for allocates decoder states lazily: do it on the main
        # thread so the state dict is never mutated concurrently
        futs = [(fs, self._voice_pool.submit(synth, self.voice_for(ci),
                                             fs))
                for ci, fs in by_c.items()]
        for fs, fut in futs:
            for f, audio in zip(fs, fut.result()):
                f["_voice_audio"] = audio

    def _synth_voice_device(self, frames: list) -> None:
        """Synthesize this block's voice candidates in ONE device
        dispatch (voice.speech_pool): every candidate carries channel-
        decoded params (_prepare_voice_batch guarantees it in device
        mode, stolen frames included), so each carrier's frames form an
        in-order parameter stream for its persistent device decoder
        slot.  Audio is bit-identical to the host path (the decoder is
        bit-exact vs the C decoder); the near-silence rejection is
        applied per slot exactly as codec.decode_params does."""
        by_c: dict = {}
        for f in frames:
            if "_voice_params" in f:
                by_c.setdefault(f["carrier"], []).append(f)
        if not by_c:
            return
        items = [(ci, np.concatenate([f["_voice_params"] for f in fs]))
                 for ci, fs in by_c.items()]
        pcms = self._voice_device.synthesize(items)
        for (ci, fs), pcm in zip(by_c.items(), pcms):
            off = 0
            for f in fs:
                n = len(f["_voice_params"]) * 480 // 2
                a = pcm[off:off + n]
                off += n
                if a.size and float(np.max(np.abs(a))) < 1e-5:
                    # near-silent == decode failure (voice.py:223-232)
                    a = np.zeros(0, np.float32)
                f["_voice_audio"] = a

    def _synth_voice(self, frames: list) -> None:
        """Block-level speech synthesis pass: device pool when enabled,
        else the host thread pool (no-op without either)."""
        if self._voice_device is not None:
            self._synth_voice_device(frames)
        else:
            self._synth_voice_parallel(frames)

    def _try_voice(self, frame: dict) -> None:
        """Voice candidate path (modern.py:2088-2228): soft bits ->
        codec block -> PCM; channel decoding may already have happened
        batched on device (_prepare_voice_batch)."""
        if frame.get("stolen"):
            self._try_voice_stolen(frame)
            return
        block = frame.pop("_voice_block", None)
        if block is None:
            if not self._is_voice_candidate(frame):
                return
            from tetraear_tpu_torch.voice.codec import build_codec_block
            soft = frame.get("soft_symbols")
            if soft is None:
                return
            block = build_codec_block(soft)
            if block is None:
                return
        if self._records_dir is not None:
            with open(self._records_dir / "tetra_frames.bin", "ab") as fh:
                fh.write(block)
        params = frame.pop("_voice_params", None)
        audio = frame.pop("_voice_audio", None)   # pre-synthesized
        if audio is None:
            if self._voice_device is not None:
                # device mode: every candidate was synthesized in
                # _synth_voice_device (or its channel decode failed);
                # the host decoder must not fork the device state
                return
            vp = self.voice_for(frame.get("carrier", 0))
            if params is not None:
                audio = vp.decode_params(params)
            else:
                audio = vp.decode_frame(block)
        if len(audio):
            frame["has_voice"] = True
            self.stats.voice_frames += 1
            if self.on_audio:
                self.on_audio(audio)

    def _try_voice_stolen(self, frame: dict) -> None:
        """Frame-stealing slot (normal training sequence 2): block 2 is a
        half-slot-coded speech frame (EN 300 395-2 §5), block 1 is STCH
        signalling already parsed by the MAC layer.  The reference drops
        these slots (its codec only consumes full 432-bit blocks)."""
        if not self._is_voice_candidate(frame):
            return
        audio = frame.pop("_voice_audio", None)   # device-synthesized
        frame.pop("_voice_params", None)
        if audio is None:
            if self._voice_device is not None:
                # device mode channel-decodes stolen candidates in
                # _prepare_voice_batch; reaching here means that failed
                # (no soft bits / malformed half slot) — nothing to do,
                # and the host decoder must not fork the device state
                return
            from tetraear_tpu_torch.voice.codec import stolen_soft_bits
            soft = frame.get("soft_symbols")
            if soft is None:
                return
            half = stolen_soft_bits(soft)
            if half is None:
                return
            vp = self.voice_for(frame.get("carrier", 0))
            params = vp.channel_decode_stolen(half)
            if params is None:
                return
            audio = vp.decode_params(params)
        if len(audio):
            frame["has_voice"] = True
            self.stats.voice_frames += 1
            self.stats.stolen_frames += 1
            if self.on_audio:
                self.on_audio(audio)

    def _maybe_afc_retune(self, source) -> None:
        """Apply the smoothed capture-level AFC offset by retuning the
        source, the way the reference applies its GUI AFC to the tuner
        (modern.py:5135-5169).  Only fires past ``afc_retune_hz`` so the
        per-carrier d^4 loops absorb small residuals; after a retune the
        carrier loops re-lock (same transient as a reference retune)."""
        if not self.config.afc or abs(self._afc_offset) \
                < self.config.afc_retune_hz:
            return
        if not hasattr(source, "set_frequency"):
            return
        new_freq = self.config.frequency + self._afc_offset
        logger.info("AFC retune: %+.0f Hz -> %.6f MHz",
                    self._afc_offset, new_freq / 1e6)
        source.set_frequency(new_freq)
        self.config.frequency = new_freq
        self._afc_offset = 0.0
        self.stats.afc_offset_hz = 0.0
        if self.on_status:
            self.on_status(f"afc retune {new_freq / 1e6:.6f} MHz")

    # -- run loops ---------------------------------------------------------

    def run(self, source, max_blocks: int | None = None) -> PipelineStats:
        """Consume a source until EOF/max_blocks; callbacks fire per event.

        A final partial block at EOF is zero-padded so the tail of a
        capture file still decodes (frames inside the padding region fail
        CRC and are filtered normally)."""
        with source:
            n = 0
            while max_blocks is None or n < max_blocks:
                block = source.read_samples(self.block_len)
                if len(block) < self.block_len:
                    if len(block) > self.block_len // 8:
                        pad = np.zeros(self.block_len - len(block),
                                       np.complex64)
                        self.process_block(np.concatenate([block, pad]))
                    break
                self.process_block(block)
                self._maybe_afc_retune(source)
                n += 1
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        return self.stats

    def close(self) -> None:
        """Release held resources: the voice synthesis pool, the JSONL
        sink and the worker-sharded frame layer (idempotent; also run by
        __del__)."""
        if self._voice_pool is not None:
            self._voice_pool.shutdown(wait=True)
            self._voice_pool = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        closer = getattr(self.batch, "close", None)
        if closer is not None:
            closer()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def run_offline(self, source, blocks_per_dispatch: int = 16,
                    max_blocks: int | None = None) -> PipelineStats:
        """Offline decode, S = blocks_per_dispatch blocks per batch.  A
        final partial block is zero-padded.  Detection gating and
        spectrum callbacks do not apply: offline decode wants every
        frame."""
        runner = self.runner
        runner.s = int(blocks_per_dispatch)
        # the block-level passes of process_block
        on_frames = self._finish_block

        span = runner.s * self.block_len
        with source:
            n = 0
            while max_blocks is None or n < max_blocks:
                want = span if max_blocks is None else min(
                    span, (max_blocks - n) * self.block_len)
                chunk = np.asarray(source.read_samples(want), np.complex64)
                if len(chunk) == 0:
                    break
                if len(chunk) % self.block_len:
                    pad = self.block_len - len(chunk) % self.block_len
                    chunk = np.concatenate(
                        [chunk, np.zeros(pad, np.complex64)])
                self.stats.blocks += len(chunk) // self.block_len
                self.stats.samples += len(chunk)
                # a dispatch is the root span of the tracer's record here
                with prof.block("dispatch"):
                    out = runner.run(chunk, state=self.state,
                                     on_frames=on_frames)
                self.state = out["state"]
                n += len(chunk) // self.block_len
                if len(chunk) < want:
                    break
        self.dispatches = runner.dispatches
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        return self.stats

    def frames(self, source, max_blocks: int | None = None):
        """Generator yielding frames as they decode (FrameStream)."""
        with source:
            n = 0
            while max_blocks is None or n < max_blocks:
                block = source.read_samples(self.block_len)
                if len(block) < self.block_len:
                    break
                yield from self.process_block(block)
                n += 1

    # -- checkpoint --------------------------------------------------------

    def save_checkpoint(self, path) -> None:
        """SEAMLESS checkpoint: DSP state, frame-layer stream positions
        AND alignment tails, the classic chain's device bit tail (the
        fused path carries its own in the state) and each carrier's MAC
        parser state (``parsers``: network identity and the open fragment
        chain, which the JAX package's checkpoint drops, so that a chain
        straddling the restart loses its reassembled text there).  A
        kill/restore across a block boundary reproduces the uninterrupted
        run's frames.  The layout is the JAX package's
        (runtime/checkpoint.py), so either package restores the other's
        file (the JAX package ignores ``parsers``; its files restore
        fresh parsers).  With voice on it also carries the lazy view's
        previous-block soft planes (aux ``prev_soft`` / ``prev_nc``),
        every carrier's host speech decoder state (aux ``vhost``, extra
        ``vhost_carriers``) and, with device synthesis, the slot bank's
        decoder states (aux ``vdev_{i}``, one a SpeechState leaf, extra
        ``vdev`` / ``vdev_n``: the carrier->slot map), so a call
        straddling the restart gives the uninterrupted run's audio."""
        from tetraear_tpu_torch.runtime import checkpoint
        layer = self._tails_layer()
        extra = {
            "sym_base": self.batch._sym_base.tolist(),
            "emitted_until": self.batch._emitted_until.tolist(),
            "stats": self.stats.as_dict(),
            "fm_prev": [float(np.real(self._fm_prev)),
                        float(np.imag(self._fm_prev))],
            "afc_offset": float(self._afc_offset),
            "batch_first": bool(getattr(self.batch, "_first", False)),
            "trackers": [t.slot_counter for t in self.trackers],
            "parsers": {str(ci): st
                        for ci, st in self._parser_states().items()},
        }
        aux = {}
        if self.runner._tail_bits is not None:
            aux["tail_bits"] = self.runner._tail_bits.cpu().numpy()
        if self.runner._prev_soft is not None:
            aux["prev_soft"] = self.runner._prev_soft.cpu().numpy()
            aux["prev_nc"] = np.asarray(self.runner._prev_nc)
        for name in ("_tail_hard", "_tail_soft", "_tail_valid"):
            aux["batch" + name] = np.asarray(getattr(layer, name))
        # host voice decoder states (stateful LPC/excitation memory)
        vhost = [(ci, vp.state_bytes())
                 for ci, vp in sorted(self._voice_states.items())
                 if vp.stateful]
        vhost = [(ci, b) for ci, b in vhost if b is not None]
        if vhost:
            aux["vhost"] = np.stack(
                [np.frombuffer(b, np.int16) for _, b in vhost])
            extra["vhost_carriers"] = [int(ci) for ci, _ in vhost]
        if self._voice_device is not None:
            leaves, meta = self._voice_device.checkpoint_state()
            for i, leaf in enumerate(leaves):
                aux[f"vdev_{i}"] = leaf
            extra["vdev"] = meta
            extra["vdev_n"] = len(leaves)
        checkpoint.save_state(path, self.state, extra=extra, aux=aux)

    def load_checkpoint(self, path) -> None:
        """Restore a checkpoint of this package or of the JAX package
        (same configuration) into this Pipeline."""
        import torch
        from tetraear_tpu_torch.runtime import checkpoint
        leaves, extra, aux = checkpoint.load_state(path)
        self.state = checkpoint.restore_into(
            self.state, leaves, saved_treedef=extra.get("__treedef__"))
        if "sym_base" in extra:
            self.batch._sym_base = np.asarray(extra["sym_base"], np.int64)
        if "emitted_until" in extra:
            self.batch._emitted_until = np.asarray(
                extra["emitted_until"], np.int64)
        if "fm_prev" in extra:
            self._fm_prev = complex(*extra["fm_prev"])
        if "afc_offset" in extra:
            self._afc_offset = float(extra["afc_offset"])
        for t, cnt in zip(self.trackers, extra.get("trackers", [])):
            t.slot_counter = int(cnt)
        parsers = {int(ci): st for ci, st in extra.get("parsers", {}).items()}
        if self.decoders:
            for ci, st in parsers.items():
                checkpoint.restore_parser(self.decoders[ci].protocol_parser,
                                          st)
        else:
            self.batch.set_parser_states(parsers)
        if "tail_bits" in aux:
            self.runner._tail_bits = torch.from_numpy(
                np.array(aux["tail_bits"], np.uint8)).to(self.device)
        if "prev_soft" in aux:
            self.runner._prev_soft = torch.from_numpy(
                np.array(aux["prev_soft"], np.float32)).to(self.device)
            self.runner._prev_nc = np.asarray(aux["prev_nc"])
        if self.voice is not None:
            for i, ci in enumerate(extra.get("vhost_carriers", [])):
                self.voice_for(int(ci)).set_state_bytes(
                    aux["vhost"][i].tobytes())
        if "vdev" in extra and self._voice_device is not None:
            self._voice_device.restore_state(
                [aux[f"vdev_{i}"] for i in range(int(extra["vdev_n"]))],
                extra["vdev"])
        layer = self._tails_layer()
        for name in ("_tail_hard", "_tail_soft", "_tail_valid"):
            if "batch" + name in aux:
                setattr(layer, name, np.array(aux["batch" + name]))
        self.batch._first = bool(extra.get("batch_first", False))

    def _parser_states(self) -> dict:
        """{carrier: MAC parser state} of the frame layer's decoders, in
        this process or in the workers (runtime.checkpoint.parser_state);
        carriers whose parser is in its initial state are left out."""
        from tetraear_tpu_torch.runtime import checkpoint
        if not self.decoders:
            return self.batch.parser_states()
        states = {ci: checkpoint.parser_state(d.protocol_parser)
                  for ci, d in enumerate(self.decoders)}
        return {ci: st for ci, st in states.items() if st is not None}

    def _tails_layer(self):
        """The layer holding the host alignment tails: the in-process
        layer, or the parent-side one inside the sharded layer."""
        return getattr(self.batch, "_inner", self.batch)


def _jsonable(frame: dict) -> dict:
    out = {}
    for k, v in frame.items():
        if k in ("bits", "soft_symbols"):
            continue
        if isinstance(v, (bytes, bytearray)):
            out[k] = v.hex()
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, np.generic):
            out[k] = v.item()
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        else:
            out[k] = v
    return out
