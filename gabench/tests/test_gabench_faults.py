"""The check rejects what it must: every cell of `BENCHMARK.json`, driven
on the CPU at a tiny size with the port's plain kernel twins (the
harness's look for a card skipped), comes out correct as it stands and
not correct when the control (the reference in bfloat16) is put in the
program's place, or when the timed path is broken underneath: a step
that returns its state unchanged, half of the replica batch left out, an
answer altered where it is produced.  Each fault is planted in the
result of the cell's backend's `segment`, which every backend's run
passes through whichever kernels or fitness stage it runs, and, where
the cell's yardstick gives K1's block or global form, in K1's kernel
(its CPU twin).  The cells and their CPU cuts come from the manifest and
each configuration's reference, so a new deployment is covered as it
comes.  (No cell has an exchange between chips to leave out.)"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from gabench import trace as TR  # noqa: E402
from gabench import harness as H  # noqa: E402
from gabench.harness import run_cell  # noqa: E402
from repro_torch.ga import backends as B  # noqa: E402
from repro_torch.kernels import ga_step as K  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2 ** 31 + 11
FAULTS = ("unchanged", "half_batch", "altered_answer")


def _config(cell):
    """The configuration file of a cell, as a dict."""
    name = {w["name"]: w for w in MANIFEST["workloads"]}[cell]["config"]
    conf = {c["name"]: c for c in MANIFEST["configs"]}[name]
    return json.loads((ROOT / conf["file"]).read_text())


def _form(cell):
    conf = _config(cell)
    return H.work_of(ROOT, conf).form(
        H.reference_of(ROOT, conf).shape_of(conf))


# every fault at the segment's result in every cell, and in K1's kernel
# in the cells whose yardstick says K1 runs them
BROKEN = [(cell, kind) for cell in CELLS
          for kind in ((*FAULTS,) if _form(cell) in ("block", "global")
                       else ()) + tuple(f"segment_{f}" for f in FAULTS)]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory, copy_bench):
    """The benchmark's own files beside each configuration cut to a CPU's
    size by its reference's `cpu_cut`."""
    root = copy_bench(tmp_path_factory.mktemp("gabench"))
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(H.reference_of(ROOT, conf).cpu_cut(conf)))
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


def _broken_segment(kind, segment):
    """`segment` with its result broken as `kind` says: the state it was
    handed back, half the replicas' state and results left at what they
    were handed (the results copied from replica 0), or one bit of a
    replica's best chromosome flipped."""
    def broken(self, state, gens):
        before = [t.clone() for t in state]
        seg = segment(self, state, gens)
        leaves, rep = list(seg.state), seg.telemetry.per_repeat
        if kind == "unchanged":
            leaves = before
        elif kind == "half_batch":
            h = leaves[0].shape[0] // 2 or 1
            leaves = [torch.cat([a[:h], b[h:]]) for a, b in zip(leaves,
                                                               before)]

            def rest(a):
                return np.concatenate([a[:h], np.repeat(a[:1], len(a) - h,
                                                        axis=0)])
            rep = dataclasses.replace(
                rep, best=rest(rep.best), best_x=rest(rep.best_x),
                traj_best=rest(rep.traj_best), traj_mean=rest(rep.traj_mean))
        elif kind == "altered_answer":
            bx = rep.best_x.copy()
            bx[0, 0] ^= 1
            rep = dataclasses.replace(rep, best_x=bx)
        seg.telemetry.per_repeat = rep
        return dataclasses.replace(seg, state=type(seg.state)(*leaves))
    return broken


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


@pytest.mark.parametrize("cell,kind", BROKEN)
def test_broken_step_is_rejected(tiny_root, cell, kind, monkeypatch):
    if kind.startswith("segment_"):
        cls = B.BACKENDS[_config(cell)["backend"]]
        monkeypatch.setattr(cls, "segment", _broken_segment(
            kind[len("segment_"):], cls.segment))
    else:
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
