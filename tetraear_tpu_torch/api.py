"""Offline decode pipeline (tetraear_tpu/api.py).

``Pipeline(PipelineConfig(...)).run_offline(source)`` is the port's
entry point: the same call the JAX CLI's ``decode`` makes, for every
receive-chain configuration the JAX ``Pipeline.run_offline`` accepts —
``frontend="conv"`` or ``"fft"``, ``carrier_afc`` on or off, any rate
``choose_decim`` accepts, ``sparse_hits`` on or off.  Banks the fused
back half serves (fft frontend on a 72 kHz * 2^m rate, no AFC) take it;
all others run the classic chain (dsp/backhalf.try_fused).  It runs on
the card unless ``device="cpu"`` is given.

Not ported yet, and raising when asked for: voice (``voice=True``), the
sharded frame layer (``frame_workers``).  The streaming
``process_block`` path, checkpoints and the detection gate are later
parts of the port.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tetraear_tpu_torch.crypto.tea import TetraKeyManager
from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
from tetraear_tpu_torch.frame.aggregator import CallAggregator
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
from tetraear_tpu_torch.frame.decoder import TetraDecoder
from tetraear_tpu_torch.frame.structure import FrameStructureTracker
from tetraear_tpu_torch.frame.validator import TetraSignalValidator
from tetraear_tpu_torch.runtime.stream import DecodeRunner


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
    carrier_afc: bool = True            # per-carrier d^4 tracking loop
    frontend: str = "conv"              # "fft": wideband FFT channelizer
                                        # (the fleet-scale frontend; on a
                                        # 72 kHz-family rate with
                                        # carrier_afc off it enables the
                                        # fused back half)
    voice: bool = False                 # voice chain: not ported yet
    frame_workers: int = 0              # sharded frame layer: not ported
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
    """Offline demod/decode engine over any IQSource."""

    def __init__(self, config: PipelineConfig, on_frame=None):
        if config.voice:
            raise ValueError("voice decode is not ported yet (voice=False)")
        if config.frame_workers:
            raise ValueError("the sharded frame layer is not ported yet "
                             "(frame_workers=0)")
        self.config = config
        self.on_frame = on_frame
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
        # the runner picks the back half (backhalf.try_fused)
        self.runner = DecodeRunner(self.bank, self.batch,
                                   device=self.device,
                                   sparse=config.sparse_hits)
        self.state = self.runner.init_state()
        self.dispatches = 0
        self.validator = (TetraSignalValidator(config.expected_mcc)
                          if config.validate else None)
        self.aggregator = CallAggregator()
        self.trackers = [FrameStructureTracker()
                         for _ in range(self.n_carriers)]
        self.stats = PipelineStats()
        self._jsonl = None
        if config.records_dir:
            rec = Path(config.records_dir)
            rec.mkdir(parents=True, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S")
            self._jsonl = open(rec / f"frames_{ts}.jsonl", "a",
                               encoding="utf-8")

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
        self.aggregator.add_frame(frame)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(_jsonable(frame)) + "\n")
            self._jsonl.flush()
        if self.on_frame:
            self.on_frame(frame)

    def run_offline(self, source, blocks_per_dispatch: int = 16,
                    max_blocks: int | None = None) -> PipelineStats:
        """Offline decode, S = blocks_per_dispatch blocks per batch.  A
        final partial block is zero-padded.  Detection gating and
        spectrum callbacks do not apply: offline decode wants every
        frame."""
        runner = self.runner
        runner.s = int(blocks_per_dispatch)

        def on_frames(frames):
            for f in frames:
                ci = f["carrier"]
                f["carrier_offset_hz"] = float(self.bank.freqs_hz[ci])
                f["frequency"] = self.config.frequency + float(
                    self.bank.freqs_hz[ci])
                self._handle_frame(f)

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
                out = runner.run(chunk, state=self.state,
                                 on_frames=on_frames)
                self.state = out["state"]
                n += len(chunk) // self.block_len
                if len(chunk) < want:
                    break
        self.dispatches = runner.dispatches
        self.close()
        return self.stats

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


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
