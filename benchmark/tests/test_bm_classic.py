"""The classic chain through the harness, on the CPU (run from the
checkout's root):

    python -m pytest benchmark/tests/test_bm_classic.py -q

A test-size twin of ``rtl80`` (``configs/rtl80.json`` with 8 carriers:
2.4 Msps, the conv front end, carrier AFC and the detection gate,
130,800-sample blocks) under ``tests/data/tiny.json``'s traffic: the
reference agrees with the program, the control is not correct, and
neither is the program with the classic chain's carried bit tail
zeroed before every block.  ``rtl80.busy`` itself is found by name, and
its readers average over the window's blocks the program's tracer kept.
"""

from __future__ import annotations

import json
import shutil
import time
import types

import pytest

from test_bm_harness import BENCH, DATA, LIMIT, ROOT, SEED
from tebench import cells, harness

NEW = ("classic.frontend_ms", "classic.timing_ms", "classic.scan_ms",
       "classic.enqueue_ms", "gate_ms")


def _twin(tmp):
    """The cell ``rtl8.tiny``: ``rtl80`` at 8 carriers, in a copy of the
    benchmark."""
    root = tmp / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    cfg = json.loads((BENCH / "configs" / "rtl80.json").read_text())
    cfg["n_carriers"] = 8
    (root / "configs" / "rtl8.json").write_text(json.dumps(cfg))
    shutil.copy(DATA / "tiny.json", root / "traffic" / "tiny.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rtl8.tiny", "config": "rtl8",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("rtl8.tiny")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "limits" / "rtl8.tiny.json").write_text(json.dumps(
        {"failed_share": {"limit": LIMIT}}))
    return cells.load("rtl8.tiny", tmp / "BENCHMARK.json", root)


@pytest.fixture
def tracer():
    from tetraear_tpu_torch.runtime import profiling
    t = profiling.tracer()
    t.enable(False)
    t.reset()
    yield t
    t.enable(False)
    t.reset()


def _run(tmp, trace=False, control=False, seed=SEED):
    """A run of the twin long enough for three window blocks (about 3 s
    a block here): a slot crosses a block edge inside the judged span
    only from the window's third block on."""
    cell = _twin(tmp)
    res = harness.run_cell(cell, seed, 12.0, trace=trace, device="cpu",
                           t_start=time.perf_counter(), control=control)
    assert res["run"].blocks >= 3
    out, _ = harness.result_line(cell, res, trace, "cpu", 1)
    return cell, res, out


def test_rtl80_busy_found_by_name():
    cell = cells.load("rtl80.busy", ROOT / "BENCHMARK.json")
    cfg = cell.config
    assert (cfg["n_carriers"], cfg["sample_rate"], cfg["block_len"]) == \
        (80, 2400000, 130800)
    p = cfg["pipeline"]
    assert (p["frontend"], p["carrier_afc"], p["detect_gate"]) == \
        ("conv", True, True)
    assert cell.traffic["name"] == "busy" and cell.chips == 1
    assert cell.limits["failed_share"]["limit"] > 0
    names = [m["name"] for m in cell.per_layer]
    for name in NEW:
        assert name in names
        assert hasattr(cells.metric_reader(name), "compute")
    assert {m["name"] for m in cell.end_to_end} == {"realtime_carriers",
                                                    "setup_s"}
    # the offsets span the dongle's +-1 MHz
    offs = harness.offsets(cfg)
    assert max(abs(o) for o in offs) < 1e6
    # the fleet cells report none of the new metrics
    for w in ("fleet1024.allslots.busy", "fleet1024.quiet"):
        c = cells.load(w, ROOT / "BENCHMARK.json")
        assert not set(NEW) & {m["name"] for m in c.per_layer}


def test_classic_reference_agrees_and_metrics_read(tmp_path, tracer):
    _, res, out = _run(tmp_path, trace=True)
    v = res["verdict"]
    assert v["expected"] > 50 and out["correct"] is True, v
    m = out["metrics"]
    # host spans read on the CPU; the stages' CUDA events do not exist here
    assert m["classic.enqueue_ms"]["value"] > 0
    assert m["gate_ms"]["value"] > 0
    for name in ("classic.frontend_ms", "classic.timing_ms",
                 "classic.scan_ms"):
        assert name not in m


def test_classic_control_is_not_correct(tmp_path):
    _, res, out = _run(tmp_path, control=True)
    assert out["correct"] is False, res["verdict"]


def test_classic_tail_zeroed_is_not_correct(tmp_path, monkeypatch):
    """The classic chain's carried bit tail (``DecodeRunner._tail_bits``)
    zeroed before every block: the slots across a block edge are lost."""
    import torch

    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    step = DecodeRunner.step

    def untailed(self, x, state):
        if self._tail_bits is not None:
            self._tail_bits = torch.zeros_like(self._tail_bits)
        return step(self, x, state)
    monkeypatch.setattr(DecodeRunner, "step", untailed)
    _, res, out = _run(tmp_path, seed=SEED + 5)
    assert out["correct"] is False, res["verdict"]
    assert res["verdict"]["missed"] > 0


def test_readers_average_the_blocks_the_tracer_kept(tracer):
    """A window longer than the tracer's ring (a 51 s window of rtl80.busy
    holds ~1,200 blocks): each reader gives the mean over the blocks the
    tracer kept, not their sum over every block of the window; a program
    without the spans reads None."""
    from tetraear_tpu_torch.runtime import profiling as prof
    readers = {n: cells.metric_reader(n) for n in NEW}
    n = prof.BLOCKS_KEPT + 100
    run = types.SimpleNamespace(blocks=n, t_lo=time.perf_counter())
    tracer.enable()
    for _ in range(n):
        with prof.block():
            with prof.span("gate"):
                pass
            with prof.span("step"):
                for stage in ("frontend", "timing", "scan"):
                    with prof.span(stage):
                        pass
        tracer.blocks[-1].device_ms.update(frontend=1.0, timing=2.0,
                                           scan=3.0)
    run.t_hi = time.perf_counter()
    kept = list(tracer.blocks)
    assert len(kept) == prof.BLOCKS_KEPT < n
    for name, ms in (("frontend", 1.0), ("timing", 2.0), ("scan", 3.0)):
        assert readers[f"classic.{name}_ms"].compute(run) == \
            pytest.approx(ms)
    host = sum(b.ms(s) for b in kept for s in ("frontend", "timing", "scan"))
    assert readers["classic.enqueue_ms"].compute(run) == \
        pytest.approx(host / len(kept))
    assert readers["gate_ms"].compute(run) == \
        pytest.approx(sum(b.ms("gate") for b in kept) / len(kept))
    tracer.reset()
    with prof.block():
        pass
    run.t_lo, run.t_hi = 0.0, time.perf_counter()
    assert all(r.compute(run) is None for r in readers.values())
