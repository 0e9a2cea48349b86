"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch_kernels/`` at the root of the checkout. A library is
named by a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. All missing libraries are compiled
together, one ``nvcc`` per source, started at once. Each compiler's output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside its
library as ``.log``.

A failed build raises; nothing falls back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# source stem -> {C function: argtypes}; every function returns cudaError_t as int
SIGNATURES: dict[str, dict[str, list]] = {
    "nmf_update": {
        "mu_update_h": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "mu_update_w": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "silhouette_sums": {
        "silhouette_dist_sums": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "pairwise_dist": {
        "pairwise_sq_dists": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *[_L] * 12, _F, _I, _I, _P],
    },
}


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled library: where it is, how long nvcc took, what it said."""

    name: str
    path: Path
    seconds: float | None  # None: reused from an earlier build
    log: str


_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, named by its content hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Built]:
    """Compile every library in ``names`` (default: all) that is not built yet."""
    names = list(SIGNATURES) if names is None else list(names)
    out: dict[str, Built] = {}
    jobs = []
    for name in names:
        path = library_path(name)
        if path.is_file():
            log_path = path.with_suffix(".log")
            log = log_path.read_text() if log_path.is_file() else ""
            out[name] = Built(name, path, None, log)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc, time.perf_counter()))
    failures = []
    for name, path, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)  # atomic: concurrent builders never see half a library
        out[name] = Built(name, path, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:  # the threads executor reaches the first launch from several workers
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name].path
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
