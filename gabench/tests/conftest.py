"""Each test leaves the port's span recorder off and empty: a traced run
loads the metric readers, whose load turns the recorder on
(`gabench/program_spans.py`), and later tests in the same process would
otherwise record."""

import pytest

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
