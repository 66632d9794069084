"""The scheduler journal of the port (`repro_torch.serve.journal`) against
the JAX package's (`repro.serve.journal`): the same event lists replay to
the same jobs, units, job-to-unit map and highest unit seq; a torn tail
ends the log in both; specs cross between the packages through
`spec_to_json` / `spec_from_json`; and a file one package writes the other
reads."""

import dataclasses
import json

import pytest

pytest.importorskip("torch")

from repro import ga as JGA  # noqa: E402
from repro.serve import journal as JJRN  # noqa: E402
from repro_torch import ga  # noqa: E402
from repro_torch.serve import journal as TJRN  # noqa: E402

SPEC = dict(problem="rastrigin:4", n=64, bits_per_var=10, mode="lut",
            seed=5, generations=40, bounds=((-1.0, 1.0),) * 4,
            mesh_axes=("x",), n_islands=4, migrate_every=5)

EVENTS = {
    "lifecycle": [
        {"ev": "submit", "job_id": "ga-0-F3", "spec": {"problem": "F3"},
         "backend": "fused", "priority": 2, "deadline_s": 9.5,
         "max_retries": 1},
        {"ev": "dispatch", "seq": 0, "job_ids": ["ga-0-F3"],
         "ckpt_dir": "/r/pack-0", "attempt": 0},
        {"ev": "done", "job_id": "ga-0-F3",
         "result": {"best_fitness": 0.5, "best_params": [0.1, 0.2]}},
    ],
    "park-and-finish": [
        {"ev": "submit", "job_id": "a", "spec": {"problem": "F3"}},
        {"ev": "submit", "job_id": "b", "spec": {"problem": "F3"}},
        {"ev": "dispatch", "seq": 0, "job_ids": ["a", "b"],
         "ckpt_dir": "/x/pack-0"},
        {"ev": "park", "seq": 0, "job_ids": ["a", "b"],
         "ckpt_dir": "/x/pack-0"},
        {"ev": "done", "job_id": "a", "result": {"best_fitness": 1.0}},
    ],
    "retry-split-quarantine": [
        {"ev": "submit", "job_id": "p", "spec": {"problem": "F3"}},
        {"ev": "submit", "job_id": "q", "spec": None, "backend": "reference"},
        {"ev": "submit", "job_id": "r", "spec": {"problem": "F3"}},
        {"ev": "dispatch", "seq": 3, "job_ids": ["p", "q", "r"],
         "ckpt_dir": "/y/pack-3"},
        {"ev": "requeue", "seq": 3, "job_ids": ["p", "q", "r"],
         "ckpt_dir": "/y/pack-3", "error": "boom", "backoff_s": 0.05},
        {"ev": "dispatch", "seq": 3, "job_ids": ["p", "q", "r"],
         "ckpt_dir": "/y/pack-3"},
        {"ev": "requeue", "seq": 7, "job_ids": ["p"], "ckpt_dir": "/y/pack-7",
         "isolated": True},
        {"ev": "requeue", "seq": 8, "job_ids": ["q"], "ckpt_dir": "/y/pack-8",
         "isolated": True},
        {"ev": "state", "job_id": "q", "state": "failed", "error": "boom"},
        {"ev": "dispatch", "seq": 7, "job_ids": ["p"],
         "ckpt_dir": "/y/pack-7"},
        {"ev": "state", "job_id": "r", "state": "deadline_exceeded",
         "error": "deadline 1.0s exceeded"},
        {"ev": "dispatch", "seq": 9, "job_ids": ["r"], "ckpt_dir": None},
        {"ev": "state", "job_id": "ghost", "state": "failed"},
    ],
    "empty": [],
}


def _fold(mod, events):
    jobs, units, job_unit, max_seq = mod.replay(events)
    return ({k: dataclasses.asdict(v) for k, v in jobs.items()}, units,
            job_unit, max_seq, {k: v.terminal for k, v in jobs.items()})


@pytest.mark.parametrize("name", sorted(EVENTS))
def test_replay_matches_the_jax_replay(name):
    assert _fold(TJRN, EVENTS[name]) == _fold(JJRN, EVENTS[name])


def test_replay_folds_last_event_wins():
    jobs, units, job_unit, max_seq = TJRN.replay(EVENTS["park-and-finish"])
    assert jobs["a"].terminal and jobs["a"].result == {"best_fitness": 1.0}
    assert jobs["b"].state == "preempted" and not jobs["b"].terminal
    assert units[0]["ckpt_dir"] == "/x/pack-0" and max_seq == 0
    assert job_unit["b"] == 0


@pytest.mark.parametrize("tail", [
    '{"ev":"dispatch","seq":0,"job_ids":["a"',     # torn mid-append
    '{"ev":"done","job_id":"a","res',
    "\n\n",
])
def test_torn_tail_is_end_of_log_in_both(tmp_path, tail):
    path = str(tmp_path / "journal.jsonl")
    with open(path, "w") as f:
        f.write('{"ev":"submit","job_id":"a","spec":null}\n')
        f.write('{"ev":"dispatch","seq":0,"job_ids":["a"],"ckpt_dir":"d"}\n')
        f.write(tail)
        f.write('\n{"ev":"done","job_id":"a","result":{}}\n')
    got, want = TJRN.read_journal(path), JJRN.read_journal(path)
    assert got == want
    kinds = [e["ev"] for e in got]
    assert kinds[:2] == ["submit", "dispatch"]
    assert ("done" in kinds) == (tail.strip() == "")
    assert TJRN.read_journal(str(tmp_path / "missing.jsonl")) == []


def _fields(spec):
    d = dataclasses.asdict(spec)
    d.pop("fitness")
    return d


def test_spec_json_round_trips_across_packages():
    tspec, jspec = ga.GASpec(**SPEC), JGA.GASpec(**SPEC)
    assert [f.name for f in dataclasses.fields(tspec)] == \
        [f.name for f in dataclasses.fields(jspec)]
    tj, jj = TJRN.spec_to_json(tspec), JJRN.spec_to_json(jspec)
    assert tj == jj
    wire = json.loads(json.dumps(jj))          # tuples come back as lists
    from_jax = TJRN.spec_from_json(wire)
    from_port = JJRN.spec_from_json(json.loads(json.dumps(tj)))
    assert isinstance(from_jax, ga.GASpec)
    assert from_jax == tspec and from_port == jspec
    assert _fields(from_jax) == _fields(from_port) == _fields(tspec)
    assert from_jax.compile_key() == tspec.compile_key()


def test_blackbox_specs_do_not_serialize_in_either():
    def fit(x):
        return x.sum(1)
    bounds = ((-1.0, 1.0),)
    assert TJRN.spec_to_json(ga.GASpec(fitness=fit, bounds=bounds)) is None
    assert JJRN.spec_to_json(JGA.GASpec(fitness=fit, bounds=bounds)) is None


def test_a_journal_written_by_one_package_reads_in_the_other(tmp_path):
    events = EVENTS["retry-split-quarantine"]
    for writer, reader in ((TJRN, JJRN), (JJRN, TJRN)):
        path = str(tmp_path / f"{writer.__name__}" / TJRN.JOURNAL_NAME)
        j = writer.SchedulerJournal(path)
        for ev in events:
            j.append(ev)
        j.close()
        j.append({"ev": "submit", "job_id": "late"})   # closed: dropped
        assert reader.read_journal(path) == events
        assert _fold(reader, reader.read_journal(path)) == \
            _fold(writer, events)


def test_journal_appends_are_whole_lines_under_threads(tmp_path):
    import threading
    path = str(tmp_path / TJRN.JOURNAL_NAME)
    j = TJRN.SchedulerJournal(path)

    def write(i):
        for k in range(50):
            j.append({"ev": "state", "job_id": f"w{i}-{k}", "state": "failed",
                      "error": "x" * 200})

    threads = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    j.close()
    events = JJRN.read_journal(path)
    assert len(events) == 200
    assert {e["job_id"] for e in events} == {f"w{i}-{k}" for i in range(4)
                                             for k in range(50)}
