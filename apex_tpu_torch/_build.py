"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``apex_tpu_torch/_build/``. The library's
file name carries a hash of its source, of the shared headers and of
the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. :func:`build_all` starts one ``nvcc`` per missing
library, all at once, and waits for them; a failed build raises with
the compiler's output.

Every exported launcher returns ``cudaGetLastError()`` after its launch,
and its Python wrapper raises when that code is not 0 (a refused launch
never runs, and a later synchronise would not report it).

Launch counts: every kernel wrapper calls :func:`count_launch` where it
launches its kernel, so a run can show which kernels its path went
through (:func:`launch_counts`, :func:`reset_launch_counts`).
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
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# one shared library per source; the ops modules bind their symbols
SOURCES = ("layer_norm", "flash_fwd", "flash_bwd", "flash_fwd_fp16",
           "flash_bwd_fp16", "flash_fwd_fp32", "flash_bwd_fp32",
           "flash_split3", "flash_wide",
           "fused_adam", "sumsq",
           "fused_lamb", "lamb_segment", "softmax", "fused_sgd",
           "scale_axpby", "adagrad_novograd", "xentropy", "rope", "dropout",
           "stochastic_round", "kprobe", "launch_probe")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source: the wgmma/TMA backward reaches the driver's tensor-map
# encoder through dlopen (no link against the driver library)
LINK_FLAGS = ("-ldl",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_declared: set = set()     # (library, symbol) pairs whose C types are set
_launches: Dict[str, int] = {}


def count_launch(kernel: str) -> None:
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) from the build of ``name``, or "" when the
    library was built by an earlier process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


# seconds each library took to build in this process (its nvcc's wall time)
build_seconds: Dict[str, float] = {}


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet — one
    ``nvcc`` per source, started together — and return the seconds it
    took (each library's own in :data:`build_seconds`). Raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.is_file():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = out.with_name(f"{out.name}.{os.getpid()}.out")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                   str(tmp), str(CSRC / f"{name}.cu"), *LINK_FLAGS]
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f,
                                        stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, log)
        failed = []
        while procs:
            for name in [n for n, p in procs.items()
                         if p[0].poll() is not None]:
                proc, tmp, out, log = procs.pop(name)
                build_seconds[name] = time.perf_counter() - t0
                text = log.read_text()
                log.unlink(missing_ok=True)
                if proc.returncode != 0:
                    failed.append(f"--- {name} (nvcc exit "
                                  f"{proc.returncode})\n{text}")
                    tmp.unlink(missing_ok=True)
                    continue
                out.with_suffix(".log").write_text(text)
                os.replace(tmp, out)
            time.sleep(0.05)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return time.perf_counter() - t0


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_int64
U = ctypes.c_uint32
F = ctypes.c_float


def library(name: str, launcher: str, argtypes,
            error_string: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building it first if
    needed; all sources are built together on the first call), with the
    C signatures of its ``launcher`` and its ``error_string`` function
    declared — pointers and the stream as ``c_void_p``, so ctypes never
    cuts them to 32 bits. A library with several launchers is loaded
    once; each call declares the launcher it names."""
    lib = _libs.get(name)
    if lib is not None and (name, launcher) in _declared:
        return lib
    if lib is None and not library_path(name).is_file():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        lib = _libs[name]
        fn = getattr(lib, launcher)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        es = getattr(lib, error_string)
        es.argtypes = [ctypes.c_int]
        es.restype = ctypes.c_char_p
        _declared.add((name, launcher))
        return lib
