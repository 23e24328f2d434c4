"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C entry point of the
same name (``rmsnorm_quant.cu`` also holds ``quantize``, its quantizer
without the norm: ``SOURCE_OF``).  :func:`build` compiles every source with
its own ``nvcc`` process
(all started together) into a shared library under ``build/repro_torch/`` at
the repository root, named by a hash of the source, the ``csrc/*.cuh``
headers it includes and the flags, so an edited source or header is
rebuilt; :func:`launch` loads the library with ``ctypes`` at first
use and calls the entry point.  Nothing here runs at import time: the CPU
tests import this module on machines with no ``nvcc`` and no card.

Every entry point returns ``cudaGetLastError()`` after its launch; a non-zero
code raises.  There is no fallback: a kernel that does not build or does not
launch is an error.  ``LAUNCHES`` counts successful launches per kernel --
the proof that a run went through the kernels and not their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each C entry point: pointers (and the stream) as c_void_p
SIGNATURES: Dict[str, list] = {
    "q8_matvec": [_P] * 5 + [_I] * 4 + [_P],
    "q8_matmul": [_P] * 5 + [_I] * 4 + [_P, _P],
    "paged_decode_attention": [_P] * 8 + [_I] * 8 + [_P],
    "paged_prefill_attention": [_P] * 11 + [_I] * 8 + [_P],
    "q4_matvec": [_P] * 5 + [_I] * 4 + [_P, _P],
    "decode_attention": [_P] * 7 + [_I] * 7 + [_P],
    "flash_prefill": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "rope": [_P] * 4 + [_I] * 5 + [_P],
    "rmsnorm_quant": [_P] * 4 + [_I] * 3 + [_F, _F] + [_I] * 5 + [_P],
    "quantize": [_P] * 3 + [_I] * 7 + [_P],
}

# entry points held by another entry's source, csrc/<source>.cu
SOURCE_OF: Dict[str, str] = {"quantize": "rmsnorm_quant"}
SOURCES = tuple(dict.fromkeys(SOURCE_OF.get(n, n) for n in SIGNATURES))

# q8_matmul_dp4a / q4_matvec_dp4a: the q8_matmul / q4_matvec launches
# (counted there too) that the C entry sent to the dp4a kernel rather than
# the tensor cores
LAUNCHES: Dict[str, int] = {name: 0 for name in (*SIGNATURES,
                                                 "q8_matmul_dp4a",
                                                 "q4_matvec_dp4a")}

_fns: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and every file of ``csrc/`` it includes with ``#include
    "..."``, transitively, with their bytes."""
    if path not in seen and path.exists():
        seen[path] = path.read_bytes()
        for inc in _INCLUDE.findall(seen[path]):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """The library of kernel ``name`` (a source, or an entry point held by
    one), named by a hash of its source, the headers it includes and the
    flags: an edit to any of them rebuilds."""
    name = SOURCE_OF.get(name, name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path, text in _sources(CSRC / f"{name}.cu", {}).items():
        h.update(path.name.encode() + b"\0" + text)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the source of every named kernel (default: all ``SOURCES``)
    whose library is missing, one ``nvcc`` per source, all running at
    once.  Returns the seconds it took; raises with the compiler's output
    if any source fails.  The compiler's log (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside each library as
    ``<source>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in dict.fromkeys(SOURCE_OF.get(n, n)
                                     for n in (names or SOURCES))
            if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"--- {name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _entry(name: str):
    with _lock:
        fn = _fns.get(name)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            fn = getattr(ctypes.CDLL(str(path)), name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise on a non-zero CUDA error
    code, count the launch otherwise."""
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
    LAUNCHES[name] += 1
