"""The check rejects what it must: every cell of `BENCHMARK.json`, driven
on the CPU at a tiny size with the port's plain kernel twins (the
harness's look for a card skipped), comes out correct as it stands and
not correct when the control (the reference in bfloat16) is put in the
program's place, or when the timed path is broken underneath: a step
that returns its state unchanged, half of the replica batch left out, an
answer altered where it is produced.  (No cell has an exchange between
chips to leave out.)"""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gabench import trace as TR  # noqa: E402
from gabench import harness as H  # noqa: E402
from gabench.harness import run_cell  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark's own traffic and metric files beside each
    configuration cut to a CPU's size (same problem, operators and launch
    folding; V <= 4, N = 16, 3 replicas, 8-generation jobs and chunks)."""
    root = tmp_path_factory.mktemp("gabench")
    for sub in ("traffic", "metrics"):
        shutil.copytree(ROOT / "gabench" / sub, root / "gabench" / sub)
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        spec = conf["spec"]
        name, _, v = spec["problem"].partition(":")
        spec.update(problem=f"{name}:{min(int(v), 4)}", n=16, n_repeats=3,
                    generations=8,
                    gens_per_epoch=min(spec["gens_per_epoch"], 4))
        conf["chunk_generations"] = 8
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(conf))
    return root


def _run(root, cell, system="repro_torch", trace=False):
    return run_cell(root, MANIFEST, cell, SEED, 0.3, trace, device="cpu",
                    t0=time.perf_counter(), system=system)


def _broken(kind):
    plain = K.ga_generation_kernel

    def kernel(x, sel, cross, mut, **kw):
        out = list(plain(x, sel, cross, mut, **kw))
        if kind == "unchanged":
            out[:4] = [x, sel, cross, mut]
        elif kind == "half_batch":
            h = x.shape[0] // 2 or 1
            for i, t in enumerate((x, sel, cross, mut)):
                out[i] = torch.cat([out[i][:h], t[h:]])
            out[4] = torch.cat([out[4][:h], out[4][:h][:, :1].expand(
                out[4].shape[0] - h, out[4].shape[1])])
        elif kind == "altered_answer":
            bx = out[6].clone()
            bx[0, 0] ^= 1
            out[6] = bx
        return tuple(out)
    return kernel


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert res["check"]["checked"]["value"] >= 2
    names = {m["name"] for m in MANIFEST["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == names
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_rejected(tiny_root, cell):
    res = _run(tiny_root, cell, system="control-bf16")
    assert not res["correct"]
    assert res["check"]["state_words_differing"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half_batch",
                                  "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_rejected(tiny_root, cell, kind, monkeypatch):
    monkeypatch.setattr(K, "ga_generation_kernel", _broken(kind))
    res = _run(tiny_root, cell)
    assert not res["correct"], (kind, res["check"])


def test_traced_run_reports_spans_on_the_cpu(tiny_root):
    """A traced jobs run on the CPU still checks, and reads its spans."""
    res = _run(tiny_root, "cec17-rastrigin-d10.jobs", trace=True)
    assert res["correct"]
    assert res["metrics"]["init_state_ms"]["value"] > 0
    assert res["metrics"]["engine_build_ms"]["value"] > 0
    assert set(res["device"]) >= {"busy_s", "window_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cells_report_their_own_rate(tiny_root, cell):
    """Each cell reports the rate entry that lists it, and no other."""
    res = _run(tiny_root, cell)
    rates = {m["name"] for m in MANIFEST["end_to_end"]
             if m["name"].startswith("evals_per_s")
             and cell in m.get("workloads", [cell])}
    assert len(rates) == 1
    assert {k for k in res["metrics"] if k.startswith("evals_per_s")} == rates
    assert res["metrics"][rates.pop()]["value"] > 0


def test_check_buffers_are_left_out_of_the_peak(monkeypatch):
    """The bytes allocated inside `check_buffers` are noted, and the peak
    counter restarts after them."""
    alloc, resets = [4096], []
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: alloc[0])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: resets.append(alloc[0]))
    rec = H.Record()
    with H.check_buffers(rec, True):
        alloc[0] += 1536
    assert rec.held == 1536 and resets == [5632]
    with H.check_buffers(H.Record(), False):
        pass
    assert resets == [5632]


def test_idle_time_goes_to_the_host_span_it_overlaps():
    """A device gap is split over the spans the host was in meanwhile."""
    us = lambda name, cat, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                     "ts": ts, "dur": dur}
    events = [us("gabench.slice", "user_annotation", 0, 110),
              us("gabench.init_state", "user_annotation", 0, 40),
              us("gabench.run", "user_annotation", 40, 60),
              us("gabench.segment", "user_annotation", 45, 40),
              us("k", "kernel", 30, 20), us("k", "kernel", 60, 10),
              us("copy", "gpu_memcpy", 90, 5)]
    red = TR.reduce_events(events)
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["window_s"] == pytest.approx(110e-6)
    gaps = dict(red["idle_gaps"])
    assert gaps["init_state"] == pytest.approx(30e-6)
    assert gaps["segment"] == pytest.approx(25e-6)
    assert gaps["result"] == pytest.approx(10e-6)
    assert gaps["harness"] == pytest.approx(10e-6)
    assert dict(red["device_ops"])["k"] == pytest.approx(30e-6)
