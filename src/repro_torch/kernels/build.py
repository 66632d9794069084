"""Build the port's CUDA kernels from `csrc/` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/repro_torch_kernels/<name>-<hash>.so`` under the
repository root; the hash covers the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header never loads a stale library.  `load` binds a library with `ctypes`.
`build_all` starts one ``nvcc`` per source, all at once, and waits for them.
Both are safe for concurrent callers in one process (a scheduler's worker
thread and its caller may reach a kernel first together): `LOCK` covers
"built already? else build", so a library compiles once, and `library`
binds it once with its C signatures declared.

Nothing here runs at import: `ctypes` is imported and ``nvcc`` started only
inside the functions, so a host without CUDA imports the port freely.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# sm_90a: Hopper.  -fmad=false keeps every float multiply and add its own
# rounding, as PyTorch's elementwise kernels round them; the default
# IEEE division and square root stay on (never --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# re-entrant: `library` and `load` hold it while `build_all` builds
LOCK = threading.RLock()
_LIBRARIES: Dict[str, object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str) -> Path:
    """Where library `name` lives: the digest covers its source, every
    header of `csrc/` (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, "subprocess.Popen"]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names=None) -> Dict[str, Dict[str, object]]:
    """Compile every named source (default: all of `csrc/`) that has no
    current library yet, one ``nvcc`` each, all started together.  Returns
    name -> {"path", "seconds", "log"} (the ptxas register/shared-memory
    report is in "log"); raises with the compiler's output on failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        running, info = {}, {}
        for name in names:
            out = library_path(name)
            if out.exists():
                info[name] = {"path": str(out), "seconds": 0.0,
                              "log": "cached"}
            else:
                running[name] = _start(name)
        failed = []
        for name, (out, tmp, proc) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            # atomic: another process building it sees all or nothing
            os.replace(tmp, out)
            info[name] = {"path": str(out),
                          "seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


def load(name: str):
    """A ctypes handle of kernel library `name`, built on first use."""
    import ctypes
    with LOCK:
        build_all([name])
        return ctypes.CDLL(str(library_path(name)))


def library(name: str, declare: Callable[[object], None]):
    """Kernel library `name`, loaded and passed to `declare` (which sets
    its C signatures) once per process, however many threads ask first."""
    with LOCK:
        lib = _LIBRARIES.get(name)
        if lib is None:
            lib = load(name)
            declare(lib)
            _LIBRARIES[name] = lib
        return lib
