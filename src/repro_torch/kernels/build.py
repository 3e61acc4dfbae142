"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library with a plain C interface (no PyTorch headers, so ``nvcc`` takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The file name carries a hash of the source, the shared headers and the
flags, so an edited kernel is rebuilt and an unchanged one is loaded
from ``build/repro_torch/``.  ``build_all`` starts one ``nvcc`` per
source, all at once, and waits for them together.  Every C entry point
returns ``cudaGetLastError()`` after its launch; ``check`` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_decode", "paged_prefill", "mla_paged_decode",
           "mla_paged_prefill", "flash_prefill", "flash_prefill_bwd")

_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (None when loaded from the cache),
#          "ptxas": the compiler's register / spill report}
BUILD_LOG: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return OUT_DIR / f"{name}-{_digest(name)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every listed source whose library is missing, one
    ``nvcc`` per source, all started together."""
    names = list(SOURCES if names is None else names)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            BUILD_LOG.setdefault(name, {"seconds": None, "ptxas": ""})
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _libs[name] = lib
    return lib


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``fn`` of ``csrc/<name>.cu`` with its argument types
    declared (ctypes would otherwise pass a float as a double)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return f


def check(rc: int, name: str, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry."""
    if rc != 0:
        msg = load(name).error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} at launch "
                           f"({msg(rc).decode()})")
