"""The per-layer metrics read from the program's own tracer
(tebench/progtrace.py), on the test-size cell through the harness:

    python -m pytest benchmark/tests/test_bm_progtrace.py -q

A traced run switches the program's tracer on (the readers are loaded
before the warm-up blocks) and off when the window closes, and reports
every such metric but ``step_ms.spans``, whose CUDA events the CPU does
not have; an untraced run loads no reader and leaves the tracer off.
"""

from __future__ import annotations

import json
import time

import pytest

from test_bm_harness import ROOT, SEED, _tiny_root
from tebench import cells, harness

NEW = ("ingest_ms.spans", "step_ms.spans", "frame_layer_ms.spans",
       "voice_ms.spans", "fetch_ms", "frame_layer.select_ms",
       "frame_layer.parse_ms", "frame_layer.key_host_ms",
       "frame_layer.key_device_ms", "frame_layer.candidates",
       "frame_layer.keys_scored", "frame_layer.crc_yield_pct",
       "voice.evictions")


@pytest.fixture
def tracer():
    from tetraear_tpu_torch.runtime import profiling
    t = profiling.tracer()
    t.enable(False)
    t.reset()
    yield t
    t.enable(False)
    t.reset()


def _cell(tmp_path):
    """The test-size cell, named in the new metrics' ``workloads`` (and
    in the harness's own frame layer metric's)."""
    cell, root = _tiny_root(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW + ("frame_layer_ms.live",):
            m["workloads"].append(cell.name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return cells.load(cell.name, tmp_path / "BENCHMARK.json", root)


def test_every_new_metric_is_in_the_benchmark():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert got[name]["moves"] == "realtime_carriers"
        assert not hasattr(cells.metric_reader(name), "SPANS"), name


def test_traced_run_reports_the_program_spans(tmp_path, tracer):
    cell = _cell(tmp_path)
    res = harness.run_cell(cell, SEED, 2.0, trace=True, device="cpu",
                           t_start=time.perf_counter())
    # on for the window, off for the blocks that end the judged span
    assert not tracer.on
    run = res["run"]
    assert len(tracer.window(run.t_lo, run.t_hi)) == run.blocks >= 1
    out, _ = harness.result_line(cell, res, True, "cpu", 1)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) - set(m) == {"step_ms.spans"}, sorted(m)
    for name in NEW:
        if name != "step_ms.spans":
            assert m[name] is not None and m[name] >= 0, name
    # the split lies inside the frame layer's span, and the twin reads
    # the frame layer as the harness's wrappers do
    parts = sum(m[k] for k in ("frame_layer.select_ms",
                               "frame_layer.parse_ms",
                               "frame_layer.key_host_ms",
                               "frame_layer.key_device_ms"))
    assert 0 < parts <= m["frame_layer_ms.spans"]
    assert m["frame_layer.candidates"] > 0
    assert m["frame_layer.keys_scored"] > 0
    assert 0 < m["frame_layer.crc_yield_pct"] <= 100
    assert m["frame_layer_ms.spans"] == pytest.approx(
        m["frame_layer_ms.live"], rel=0.1)


def test_untraced_run_leaves_the_tracer_off(tmp_path, tracer):
    cell = _cell(tmp_path)
    res = harness.run_cell(cell, SEED, 1.0, trace=False, device="cpu",
                           t_start=time.perf_counter())
    assert not tracer.on and not tracer.blocks and not tracer.totals
    out, _ = harness.result_line(cell, res, False, "cpu", 1)
    assert set(out["metrics"]) == {"realtime_carriers", "setup_s"}
    # the counters are always on
    assert tracer.counters()["candidates"] > 0
