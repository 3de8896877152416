"""Offline decode pipeline on the fused receive path (tetraear_tpu/api.py).

``Pipeline(PipelineConfig(...)).run_offline(source)`` is the port's
entry point: the same call the JAX CLI's ``decode`` makes, restricted
to the configuration the fused path serves — the FFT frontend on a
72 kHz * 2^m rate, no per-carrier AFC, no voice, in-process frame
layer, sparse hit transfer.  Anything else raises ValueError; the
classic chain, the streaming ``process_block`` path, checkpoints and
voice are later parts of the port.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# the JAX package's stats record and frame serialiser (jax-free module
# level; the subprocess test in tests/test_torch_slice.py guards that)
from tetraear_tpu.api import PipelineStats, _jsonable
from tetraear_tpu.crypto.tea import TetraKeyManager
from tetraear_tpu.frame.aggregator import CallAggregator
from tetraear_tpu.frame.decoder import TetraDecoder
from tetraear_tpu.frame.structure import FrameStructureTracker
from tetraear_tpu.frame.validator import TetraSignalValidator
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
from tetraear_tpu_torch.runtime.stream import DecodeRunner


@dataclass
class PipelineConfig:
    sample_rate: float = 2.304e6
    frequency: float = 392.5e6          # display/centre frequency
    carrier_offsets_hz: tuple = (12_500.0,)
    auto_decrypt: bool = False
    keys: tuple = ()
    key_file: str | None = None
    expected_mcc: int | None = None
    validate: bool = True
    records_dir: str | None = None      # JSONL frame log
    frontend: str = "fft"               # the only frontend ported
    carrier_afc: bool = False           # the fused path has no AFC loop
    voice: bool = False                 # voice chain: not ported yet
    frame_workers: int = 0              # sharded frame layer: not ported
    sparse_hits: bool = True            # dense-plane fetch: not ported
    device: str = "cpu"                 # "cuda" runs the CUDA kernels


class Pipeline:
    """Offline demod/decode engine over any IQSource (fused path)."""

    def __init__(self, config: PipelineConfig, on_frame=None):
        if config.voice:
            raise ValueError("voice decode is not ported yet (voice=False)")
        if config.frame_workers:
            raise ValueError("the sharded frame layer is not ported yet "
                             "(frame_workers=0)")
        if not config.sparse_hits:
            raise ValueError("only the sparse hit transfer is ported "
                             "(sparse_hits=True)")
        self.config = config
        self.on_frame = on_frame
        self.bank = CarrierBankDemod(
            fs=config.sample_rate, freqs_hz=config.carrier_offsets_hz,
            frontend=config.frontend, afc=config.carrier_afc)
        self.block_len = self.bank.block_len
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
                                         decoders=self.decoders)
        # the runner owns the FusedRx (raises ValueError if ineligible)
        self.runner = DecodeRunner(self.bank, self.batch,
                                   device=config.device)
        self.state = self.runner.fused.init_state()
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
        final partial block is zero-padded."""
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
