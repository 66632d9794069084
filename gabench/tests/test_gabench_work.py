"""The frozen work counts reproduce the bounds the port's kernel table
states (PERF.md), and a generation's least time depends on the shapes
alone."""

import inspect
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gabench import work as W  # noqa: E402
from gabench.reference.plain import Shape  # noqa: E402


def shape(problem, n, v):
    return Shape(problem, n, v, 16, 0.02, 3)


D10 = shape("rastrigin", 1024, 10)
D100 = shape("rastrigin", 4096, 100)


def test_k1_bound_at_the_real_size():
    """K1, N=1024, V=8, x128, 64 generations: 0.0244 ms by operations
    and 0.0572 ms by the int32 class."""
    b = W.k1_bound(shape("rastrigin", 1024, 8), 128, 64)
    assert round(b["bound_ms"], 4) == 0.0244
    assert b["bound_by"] == "operations"
    assert round(b["class_bound_ms"], 4) == 0.0572
    assert b["class_bound_by"] == "int32"


@pytest.mark.parametrize("kernel,problem,n,v,ms", [
    ("ga_ffm", "rastrigin", 65536, 2, 0.0038),
    ("ga_operators", "rastrigin", 65536, 2, 0.0188),
    ("ga_best", "rastrigin", 65536, 2, 0.0013),
    ("ga_ffm", "sphere", 4096, 64, 0.0051),
    ("ga_operators", "sphere", 4096, 64, 0.0254),
    ("ga_ffm", "rastrigin", 1024, 32, 0.0006),
    ("ga_ffm", "rastrigin", 8192, 2, 0.0005)])
def test_global_form_byte_bounds(kernel, problem, n, v, ms):
    b = W.global_bounds(shape(problem, n, v), 16)[kernel]
    assert round(b["bound_ms"], 4) == ms
    assert b["bound_by"] == "bytes"


def test_one_block_bytes_of_the_cells():
    assert W.one_block_bytes(D10) == 120264
    assert W.launch_unit(D10, {"gens_per_epoch": 32}) == 32
    assert W.form(D10) == "block"
    assert W.one_block_bytes(D100) > W.SMEM_LIMIT
    assert W.launch_unit(D100, {"gens_per_epoch": 1}) == 1
    assert W.launch_unit(D100, {"gens_per_epoch": 8}) == 1
    assert W.form(D100) == "global"


def test_d100_generation_is_bound_by_its_state_bytes():
    """51 replicas of 1,032,192 words read and written: 0.1257 ms."""
    assert D100.state_words == 1032192
    b = W.generations_bound(D100, 51, 244, 1)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"] / 244, 4) == 0.1257


def test_d10_generation_is_bound_by_operations():
    b = W.generations_bound(D10, 51, 1024, 32)
    assert b["bound_by"] == "operations"
    assert 0.3 < b["bound_ms"] / 1024 * 1e3 < 0.45     # us a generation


@pytest.mark.parametrize("gens,unit", [(96, 32), (244, 1), (1024, 32),
                                       (100, 32)])
def test_generations_bound_adds_up(gens, unit):
    """A run's bytes and operations are the sums of its whole units' and
    its remainder's."""
    whole = W.generations_bound(D10, 51, gens, unit)
    full, rem = divmod(gens, unit)
    parts = [W.generations_bound(D10, 51, unit, unit)] * full
    if rem:
        parts.append(W.generations_bound(D10, 51, rem, unit))
    assert whole["bytes"] == pytest.approx(sum(p["bytes"] for p in parts))
    for k in ("int32", "fp32", "slow"):
        assert whole["ops"][k] == pytest.approx(
            sum(p["ops"][k] for p in parts), rel=1e-12)


def test_counts_depend_on_shapes_only():
    """No device, tensor or clock enters a count: the functions take
    shapes and counts, and give the same answer every time."""
    for fn in (W.generations_bound, W.k1_bound, W.global_bounds,
               W.island_ops, W.state_bytes, W.one_block_bytes):
        params = set(inspect.signature(fn).parameters)
        assert params <= {"shape", "replicas", "gens", "unit", "evals",
                          "migrations", "clock_hz"}, fn.__name__
    a = W.generations_bound(D100, 51, 244, 1)
    b = W.generations_bound(shape("rastrigin", 4096, 100), 51, 244, 1)
    assert a == b
