"""Each test leaves the port's span recorder off and empty: a traced run
loads the metric readers, whose load turns the recorder on
(`gabench/program_spans.py`), and later tests in the same process would
otherwise record.  `copy_bench` lays out a root for a run at a test's
own sizes."""

import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]

try:
    from repro_torch import trace as _trace
except ImportError:
    _trace = None


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    if _trace is not None:
        _trace.disable()
        _trace.clear()


@pytest.fixture(scope="session")
def copy_bench():
    """A function that copies the benchmark's files under a new root, less
    the configurations (a test writes its own) and the tests."""
    def copy(root: Path) -> Path:
        shutil.copytree(BENCH, root / "gabench",
                        ignore=shutil.ignore_patterns("configs", "tests",
                                                      "__pycache__"))
        return root
    return copy
