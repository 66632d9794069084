"""Kernel builds under concurrent first use in one process: a scheduler's
worker thread and its caller may reach a kernel first together, and the
library must compile once.  Runs with a stand-in compiler, so no nvcc is
needed."""

import os
import sys
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

THREADS = 16       # more than the cores, with a short switch interval


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A compiler that writes its -o file after a short sleep and appends a
    line to a log for every compile."""
    log = tmp_path / "compiles.log"
    script = tmp_path / "fake_nvcc.py"
    script.write_text(
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "time.sleep(0.2)\n"
        f"open({str(log)!r}, 'a').write(out + '\\n')\n"
        "open(out, 'w').write('library')\n")
    script.chmod(0o755)
    wrapper = tmp_path / "nvcc"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(wrapper))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return log


def _together(fn):
    """fn() in THREADS threads released at once; their results in order."""
    barrier = threading.Barrier(THREADS)
    out, errors = [None] * THREADS, []

    def run(i):
        barrier.wait(timeout=30)
        try:
            out[i] = fn()
        except Exception as e:      # noqa: BLE001 — collected for the assert
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return out


def test_concurrent_first_builds_compile_once(fake_nvcc):
    got = _together(lambda: build.build_all(["ga_step"])["ga_step"]["path"])
    compiles = fake_nvcc.read_text().splitlines()
    assert len(compiles) == 1
    assert len(set(got)) == 1
    assert got[0] == str(build.library_path("ga_step"))
    assert os.path.exists(got[0])
    # the temporary name carries the process and the thread
    assert f".{os.getpid()}-" in compiles[0]
    assert not list((build.BUILD_DIR).glob("*.tmp"))


def test_library_binds_once_under_concurrent_first_use(fake_nvcc,
                                                       monkeypatch):
    loads, declared = [], []

    def load(name):
        build.build_all([name])
        loads.append(name)
        return object()

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build, "_LIBRARIES", {})
    got = _together(lambda: build.library("lfsr_advance", declared.append))
    assert len({id(lib) for lib in got}) == 1
    assert loads == ["lfsr_advance"] and declared == [got[0]]
    assert len(fake_nvcc.read_text().splitlines()) == 1
