"""Build the CUDA sources under ``csrc/`` with nvcc and load them with
ctypes (a plain C interface: no PyTorch headers, so a build takes seconds).

Libraries go to ``build/kernels/`` at the repository root, named by a
digest of the source and flags, so an edited source never loads a stale
library.  Nothing here runs at import time: kernels build on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
# rtpulint: disable=RT006 keyed by the fixed kernel names of csrc/ (one entry per source file), never by tenant or object names
_libs: dict = {}
# rtpulint: disable=RT006 keyed by the fixed kernel names of csrc/, like _libs
BUILD_LOG: dict = {}  # name -> nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _publish_file(tmp: Path, final: Path) -> None:
    """tmp -> final, durably: the tmp file's bytes are fsynced before the
    rename and the directory after it, so a crash never leaves a name
    whose bytes are torn (concurrent builders never see half a file)."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)
    fd = os.open(final.parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def loaded(name: str) -> bool:
    """Whether ``csrc/<name>.cu`` is already built and loaded here."""
    with _lock:
        return name in _libs


def build(names) -> float:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together.  Returns the seconds spent;
    raises with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():  # built earlier: its nvcc output lies beside it
            log = out.with_suffix(".log")
            BUILD_LOG[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        _publish_file(tmp, out)
        # The report follows the library, by the same tmp -> rename path.
        log_tmp = out.with_suffix(f".log.{os.getpid()}.tmp")
        log_tmp.write_text(log)
        _publish_file(log_tmp, out.with_suffix(".log"))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use;
    ``bind(lib)`` declares its argtypes/restype once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            bind(lib)
            _libs[name] = lib
        return lib
