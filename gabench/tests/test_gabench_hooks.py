"""A deployment comes as new files: a configuration names its plain
reference (`"reference"`) and its yardstick (`"work"`), and the harness
takes from them everything that depends on the configuration's shape.

Each run case lays out a root with the benchmark's files as they are, a
copy of the manifest with one more configuration and cell, and only new
files beside them (the configuration, its reference or yardstick, probe
readers), and runs the cell on the CPU.  The other cases pin the hooks
of the benchmark's own configurations to what the harness computed
before it had hooks."""

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

from gabench import harness as H  # noqa: E402
from gabench import work as W  # noqa: E402
from gabench.reference import plain as P  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in MANIFEST["configs"]}
SEED = 2 ** 31 + 29
PLAIN = (ROOT / "gabench/reference/plain.py").read_text()

# appended to a copy of plain.py: `run` hands back its state with one
# word flipped
FLIPPED = '''

_run = run


def run(shape, st, gens, unit=1, fitness_dtype=torch.float32):
    out = _run(shape, st, gens, unit, fitness_dtype)
    out.state.x[0, 0, 0] ^= 1
    return out
'''
# appended to a copy of plain.py: each replica counts two evaluations an
# individual a generation
DOUBLED = '''

def evals_per_generation(shape):
    return 2 * shape.n
'''
# a yardstick whose least time is 0.25 ms a generation
FIXED_WORK = '''from gabench.work import *  # noqa: F401,F403
from gabench import work as _W


def generations_bound(shape, replicas, gens, unit):
    return dict(_W.generations_bound(shape, replicas, gens, unit),
                bound_ms=0.25 * gens)
'''
# probe readers: the slice's least time a generation, evaluations a
# generation over the replicas
PROBES = {
    "probe_least_ms_a_gen": '''def read(rec):
    sl = rec.slice
    return sl.least_ms / sl.gens if sl is not None and sl.gens else None
''',
    "probe_evals_a_gen": '''def read(rec):
    return rec.evals / rec.gens if rec.gens else None
'''}


def _deployment(root: Path, copy_bench, traffic: str, reference=None,
                work=None):
    """A root holding the benchmark's files and a new configuration `hook`
    (D=10's cut to a CPU's size) with a cell `hook.<traffic>` that reports
    the probe readers; `reference` and `work` are the sources of the
    configuration's own modules, where given.  Returns the manifest and
    the cell."""
    copy_bench(root)
    base = CONFIGS["cec17-rastrigin-d10"]
    conf = dict(P.cpu_cut(base), name="hook")
    new = {}
    if reference is not None:
        conf["reference"] = "gabench/reference/hook_plain.py"
        new[conf["reference"]] = reference
    if work is not None:
        conf["work"] = "gabench/hook_work.py"
        new[conf["work"]] = work
    new["gabench/configs/hook.json"] = json.dumps(conf)
    for name, src in PROBES.items():
        new[f"gabench/metrics/{name}.py"] = src
    for rel, text in new.items():
        path = root / rel
        assert not (ROOT / rel).exists(), rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    for path in (root / "gabench").rglob("*"):
        rel = path.relative_to(root)
        if path.is_file() and (ROOT / rel).exists():
            assert path.read_bytes() == (ROOT / rel).read_bytes(), rel

    manifest = json.loads(json.dumps(MANIFEST))
    cell = f"hook.{traffic}"
    manifest["configs"].append({
        "name": "hook", "source": base["source"],
        "file": "gabench/configs/hook.json", "reduced": [],
        "why": "a deployment added as new files"})
    manifest["workloads"].append({
        "name": cell, "config": "hook", "traffic": traffic, "chips": 1,
        "why": "a deployment added as new files"})
    for name in PROBES:
        manifest["per_layer"].append({
            "name": name, "unit": "1", "better": "lower",
            "source": "program_counter", "layer": "probe",
            "moves": "setup_s", "workloads": [cell]})
    return manifest, cell


def _run(root, manifest, cell, trace=False):
    return H.run_cell(root, manifest, cell, SEED, 0.3, trace, device="cpu",
                      t0=time.perf_counter())


@pytest.mark.parametrize("traffic", ["jobs", "stream"])
def test_a_named_copy_of_the_reference_is_correct(tmp_path, copy_bench,
                                                  traffic):
    manifest, cell = _deployment(tmp_path, copy_bench, traffic,
                                 reference=PLAIN)
    res = _run(tmp_path, manifest, cell)
    assert res["correct"], res["check"]
    assert res["check"]["checked"]["value"] >= 2


@pytest.mark.parametrize("traffic", ["jobs", "stream"])
def test_a_named_reference_that_flips_a_word_is_rejected(tmp_path,
                                                         copy_bench,
                                                         traffic):
    """The harness replays the configuration's reference and no other."""
    manifest, cell = _deployment(tmp_path, copy_bench, traffic,
                                 reference=PLAIN + FLIPPED)
    res = _run(tmp_path, manifest, cell)
    assert not res["correct"]
    assert res["check"]["state_words_differing"]["value"] > 0


@pytest.mark.parametrize("traffic", ["jobs", "stream"])
def test_the_named_yardstick_sets_the_least_time(tmp_path, copy_bench,
                                                 traffic):
    manifest, cell = _deployment(tmp_path, copy_bench, traffic,
                                 work=FIXED_WORK)
    res = _run(tmp_path, manifest, cell, trace=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["probe_least_ms_a_gen"]["value"] == 0.25


def test_the_default_yardstick_sets_the_least_time(tmp_path, copy_bench):
    """Without `"work"` the slice's least time is `work.py`'s."""
    manifest, cell = _deployment(tmp_path, copy_bench, "stream")
    res = _run(tmp_path, manifest, cell, trace=True)
    conf = P.cpu_cut(CONFIGS["cec17-rastrigin-d10"])
    shape = P.shape_of(conf)
    unit = W.launch_unit(shape, conf["spec"])
    chunk = conf["chunk_generations"]
    want = W.generations_bound(shape, 3, chunk, unit)["bound_ms"] / chunk
    assert res["metrics"]["probe_least_ms_a_gen"]["value"] == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("reference,factor", [(PLAIN, 1),
                                              (PLAIN + DOUBLED, 2)],
                         ids=["plain", "doubled"])
def test_the_reference_counts_the_evaluations(tmp_path, copy_bench,
                                              reference, factor):
    manifest, cell = _deployment(tmp_path, copy_bench, "jobs",
                                 reference=reference)
    res = _run(tmp_path, manifest, cell, trace=True)
    assert res["correct"], res["check"]
    assert res["metrics"]["probe_evals_a_gen"]["value"] == 3 * 16 * factor


# (cell, launch unit, form, generations of a job or chunk, least time of a
# unit and of a job or chunk in ms), as the harness computed them before
# configurations named their modules
PINNED = [
    ("cec17-rastrigin-d10.jobs", 32, "block", 96,
     0.011952994835820895, 0.03585898450746269),
    ("cec17-rastrigin-d100.stream", 1, "global", 244,
     0.12572404298507464, 30.676666488358208),
    ("cec17-rastrigin-d10.stream", 32, "block", 1024,
     0.011952994835820895, 0.38249583474626864),
]


@pytest.mark.parametrize("cell,unit,form,gens,unit_ms,run_ms", PINNED,
                         ids=[row[0] for row in PINNED])
def test_hooks_give_the_cells_what_work_gives(cell, unit, form, gens,
                                              unit_ms, run_ms):
    """At the benchmark's own cells the hooks route to `work.py`'s counts,
    float for float, and to the values the harness read before."""
    w = {w["name"]: w for w in MANIFEST["workloads"]}[cell]
    conf = CONFIGS[w["config"]]
    ref, work = H.reference_of(ROOT, conf), H.work_of(ROOT, conf)
    shape = ref.shape_of(conf)
    assert vars(shape) == vars(P.shape_of(conf))
    replicas = conf["spec"]["n_repeats"]
    gpe = conf["spec"]["gens_per_epoch"]
    assert work.launch_unit(shape, conf["spec"]) == unit == (
        gpe if W.one_block_bytes(shape) <= W.SMEM_LIMIT else 1)
    assert work.form(shape) == form
    assert ref.traj_unit(conf) == gpe
    assert ref.evals_per_generation(shape) == conf["spec"]["n"]
    run = conf["spec"]["generations"] if w["traffic"] == "jobs" \
        else conf["chunk_generations"]
    assert run == gens
    for g, ms in ((unit, unit_ms), (gens, run_ms)):
        bound = work.generations_bound(shape, replicas, g, unit)
        assert bound == W.generations_bound(shape, replicas, g, unit)
        assert bound["bound_ms"] == ms
    assert work.KERNELS == ("ga_generation", "ga_ffm", "ga_operators",
                            "ga_best", "ga_epoch", "ga_streamed_epoch")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_cuts_each_configuration_to_the_cpu_size(name):
    """The CPU tests' cut: the same problem, operators and launch folding;
    V <= 4, N = 16, 3 replicas, 8-generation jobs and chunks."""
    conf = CONFIGS[name]
    cut = P.cpu_cut(conf)
    spec = dict(conf["spec"])
    problem, _, v = spec["problem"].partition(":")
    spec.update(problem=f"{problem}:{min(int(v), 4)}", n=16, n_repeats=3,
                generations=8, gens_per_epoch=min(spec["gens_per_epoch"], 4))
    assert cut == dict(conf, spec=spec, chunk_generations=8)
    assert conf == CONFIGS[name]            # the file's dict is untouched
    assert P.leaf_shapes(P.shape_of(cut), 3) == (
        (3, 16, min(int(v), 4)), (3, 2, 16), (3, min(int(v), 4), 8),
        (3, min(int(v), 4), 16), (3,))


def test_kernels_seen_are_the_yardsticks():
    rec = SimpleNamespace(slice=SimpleNamespace(
        trace={"names": ["void (anonymous)::ga_generation<3>(...)"]}))
    assert H.ga_kernels_seen(rec, W.KERNELS)
    assert not H.ga_kernels_seen(rec, ("island_epoch",))
    assert not H.ga_kernels_seen(SimpleNamespace(slice=None), W.KERNELS)
