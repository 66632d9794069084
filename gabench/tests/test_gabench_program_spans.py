"""The readers of the port's own spans (`gabench/program_spans.py` and the
metrics that read it): their arithmetic on synthetic span lists, the
set-up's run and the traced slice left out of the window, nothing
reported (and nothing raised) against a port without the recorder, and a
traced jobs run on the CPU that reports its span metrics."""

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gabench import program_spans as PS  # noqa: E402
from gabench.harness import run_cell  # noqa: E402
from gabench.reference import plain as P  # noqa: E402
from repro_torch import trace as TR  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("seed_hash_ms", "result_ms", "host_us_per_launch.block",
           "host_us_per_launch.global", "boundary_idle_share.block",
           "boundary_idle_share.global")
MS = 1_000_000      # nanoseconds a millisecond


@pytest.fixture(autouse=True)
def _recorder():
    """Loading a reader turns the port's recorder on: each test ends with
    it off and empty."""
    yield
    TR.disable()
    TR.clear()


def _span(name, sid, t0, t1, parent=None, run=None, **attrs):
    return {"name": name, "id": sid, "parent": parent, "run": run,
            "t0": t0, "t1": t1, "attrs": attrs}


def _rec(form="block", slice_t0_ms=None):
    """A harness record: K1's form, and a traced slice started at
    `slice_t0_ms` (None: no slice started)."""
    sl = SimpleNamespace(prof=None, t0=0.0)
    if slice_t0_ms is not None:
        sl.prof, sl.t0 = object(), slice_t0_ms * MS / 1e9
    return SimpleNamespace(form=form, slice=sl)


def _jobs():
    """Three jobs of one run id each, every job 10 ms apart: a warm job
    (set-up), then two window jobs; the third ends at 30 ms."""
    spans, sid = [], 0
    for j, seed_ms, result_ms in ((0, 9.0, 1.0), (1, 3.0, 0.25),
                                  (2, 5.0, 0.75)):
        base = 10 * j * MS
        run = (j + 1, None)
        spans += [_span("init.seed_hash", sid + 1, base,
                        base + int(seed_ms * MS), sid + 2, run),
                  _span("engine.init_state", sid + 2, base,
                        base + int(seed_ms * MS), sid + 3, run),
                  _span("segment.result", sid + 4, base + 8 * MS,
                        base + 8 * MS + int(result_ms * MS), sid + 5, run),
                  _span("topology.segment", sid + 5, base + 6 * MS,
                        base + 8 * MS + int(result_ms * MS), sid + 3, run),
                  _span("engine.run", sid + 3, base, base + 10 * MS - 1,
                        None, run)]
        sid += 5
    return spans


def _stream(kernels, launches_a_segment, host_ms_a_launch, device_ms,
            gaps_ms):
    """A run_chunked run: chunk c's segment holds its launches' spans and
    counters and its timing events; chunk 1 is the set-up's.  Chunk c
    starts at 100 c ms."""
    spans, sid = [], 0
    for c, (dev, gap) in enumerate(zip(device_ms, gaps_ms), start=1):
        base = 100 * c * MS
        run = (1, c)
        seg_id = sid + 1
        for i in range(launches_a_segment):
            t = base + i * MS
            spans.append(_span("executor.launch", sid + 3 + i, t,
                               t + int(host_ms_a_launch * MS), seg_id, run))
        attrs = {"kernel_launches." + k: n for k, n in kernels.items()}
        attrs["device_ms"] = dev
        if gap is not None:
            attrs["gap_before_ms"] = gap
        spans.append(_span("topology.segment", seg_id, base,
                           base + 50 * MS, sid + 2, run, **attrs))
        spans.append(_span("engine.chunk", sid + 2, base, base + 60 * MS,
                           None, run))
        sid += 3 + launches_a_segment
    return spans


def test_window_leaves_out_the_set_up_run_and_the_slice():
    spans = _jobs()
    win = PS.window(_rec(), spans)
    assert {s["run"] for s in win} == {(2, None), (3, None)}
    # the slice started at 25 ms: job 3's spans end after it
    win = PS.window(_rec(slice_t0_ms=25), spans)
    assert {s["run"] for s in win} == {(2, None)}
    # a stream: the first chunk is the set-up's
    win = PS.window(_rec(), _stream({"ga_generation": 2}, 2, 0.05,
                                    [5.0, 5.0, 5.0], [None, 1.0, 1.0]))
    assert {s["run"] for s in win} == {(1, 2), (1, 3)}
    assert PS.window(_rec(), []) == []
    assert PS.window(_rec(), [_span("init.seed_hash", 1, 0, 5)]) == []


def test_per_run_mean():
    win = PS.window(_rec(), _jobs())
    assert PS.per_run_ms(win, "init.seed_hash") == pytest.approx(4.0)
    assert PS.per_run_ms(win, "segment.result") == pytest.approx(0.5)
    assert PS.per_run_ms(win, "absent") is None


def test_host_time_a_launch_counts_the_segments_launches():
    kernels = {"ga_ffm": 3, "ga_best": 3, "ga_generation:global": 3}
    spans = _stream(kernels, 3, 0.09, [80.0, 80.0], [None, 2.0])
    # three wrapper calls of 90 us over nine kernel launches, a segment
    assert PS.host_us_per_launch(spans, PS.GLOBAL_KERNELS) == \
        pytest.approx(30.0)
    assert PS.host_us_per_launch(spans, PS.BLOCK_KERNELS) is None
    # a launch span outside every segment counts for nothing
    stray = _span("executor.launch", 999, 0, 5 * MS, None, (1, 1))
    assert PS.host_us_per_launch(spans + [stray], PS.GLOBAL_KERNELS) == \
        pytest.approx(30.0)


def test_boundary_idle_share_over_consecutive_segments():
    spans = _stream({"ga_generation": 32}, 1, 0.1,
                    [6.0, 6.0, 6.0], [0.5, 1.0, 2.0])
    # the first segment's gap reaches before the window's first segment
    assert PS.boundary_idle_share(spans) == pytest.approx(
        100 * 3.0 / (3.0 + 18.0))
    one = _stream({"ga_generation": 32}, 1, 0.1, [6.0], [0.5])
    assert PS.boundary_idle_share(one) is None
    cpu = [dict(s, attrs={}) for s in spans]
    assert PS.boundary_idle_share(cpu) is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "gabench_metric_test_" + name.replace(".", "_"),
        ROOT / "gabench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = {
    "seed_hash_ms": ("block", _jobs, 4.0),
    "result_ms": ("block", _jobs, 0.5),
    "host_us_per_launch.block": (
        "block", lambda: _stream({"ga_generation": 32}, 32, 0.07,
                                 [6.0] * 4, [None, 0.8, 0.8, 0.8]),
        70.0),
    "host_us_per_launch.global": (
        "global", lambda: _stream({"ga_ffm": 2, "ga_best": 2,
                                   "ga_generation:global": 2}, 2, 0.03,
                                  [80.0] * 4, [None, 2.0, 2.0, 2.0]),
        10.0),
    "boundary_idle_share.block": (
        "block", lambda: _stream({"ga_generation": 32}, 1, 0.1,
                                 [6.0] * 4, [None, 9.0, 1.0, 1.0]),
        100 * 2.0 / 20.0),
    "boundary_idle_share.global": (
        "global", lambda: _stream({"ga_ffm": 1}, 1, 0.1, [80.0] * 4,
                                  [None, 9.0, 2.0, 2.0]),
        100 * 4.0 / 244.0),
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_window(name, monkeypatch):
    assert {m["name"] for m in MANIFEST["per_layer"]} >= set(READERS)
    form, spans, want = CASES[name]
    mod = _reader(name)
    assert TR.span("on") is not TR.OFF
    monkeypatch.setattr(PS, "_trace",
                        SimpleNamespace(records=spans, clear=TR.clear,
                                        enable=TR.enable))
    assert mod.read(_rec(form)) == pytest.approx(want)
    if name.startswith(("host_us", "boundary")):
        other = "global" if form == "block" else "block"
        assert mod.read(_rec(other)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reports_nothing_without_the_recorder(name, monkeypatch):
    """Against a port that has no `repro_torch.trace`, loading a reader
    and reading raise nothing and report nothing."""
    monkeypatch.setattr(PS, "_trace", None)
    mod = _reader(name)
    form = CASES[name][0]
    assert mod.read(_rec(form)) is None
    assert mod.read(_rec(form, slice_t0_ms=1.0)) is None


def test_traced_jobs_run_reports_its_span_metrics(tmp_path, copy_bench):
    """A traced jobs run on the CPU at a tiny size: the recorder is turned
    on by the readers and the span metrics come out positive."""
    copy_bench(tmp_path)
    conf = json.loads((ROOT / "gabench/configs/cec17-rastrigin-d10.json")
                      .read_text())
    path = tmp_path / "gabench/configs/cec17-rastrigin-d10.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps(P.cpu_cut(conf)))
    TR.disable()
    res = run_cell(tmp_path, MANIFEST, "cec17-rastrigin-d10.jobs",
                   2 ** 31 + 5, 0.3, True, device="cpu",
                   t0=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["seed_hash_ms"]["value"] > 0
    assert res["metrics"]["result_ms"]["value"] > 0
    assert res["metrics"]["init_state_ms"]["value"] > 0
