"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch headers),
so a build takes seconds.  It is compiled for Hopper (``sm_90a``) into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the checkout;
the hash covers the source, the ``csrc/*.cuh`` headers it includes and the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as it is.  Nothing is fetched and nothing else is compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc runs started by :func:`start` and not yet waited for, by source
_pending: dict[str, tuple[subprocess.Popen, Path, Path]] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``PATH``, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'#include "(\w+\.cuh)"', src)))
    src += b"".join((CSRC / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)             # atomic: concurrent builds agree
    out.with_suffix(".log").write_text(log)
    return log


def start(names: tuple[str, ...]) -> None:
    """Start ``nvcc`` for every named source not built or building yet,
    without waiting: :func:`build_all` and :func:`load` wait for it."""
    for name in names:
        if name not in _pending:
            job = _start(name)
            if job is not None:
                _pending[name] = job


def build_all(names: tuple[str, ...]) -> dict[str, str]:
    """Compile every named source at once (one ``nvcc`` each, all started
    together, or already started by :func:`start`) and return each
    compiler log (``-Xptxas -v``: registers, shared memory, spills); an
    already-built library returns its saved log."""
    start(names)
    logs = {}
    for name in names:
        job = _pending.pop(name, None)
        logs[name] = _finish(name, job) if job is not None else \
            library_path(name).with_suffix(".log").read_text()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
