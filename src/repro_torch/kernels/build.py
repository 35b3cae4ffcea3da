"""Build the CUDA sources in ``repro_torch/csrc`` with ``nvcc`` and load
them with ``ctypes``.

Each source compiles on its own into ``build/repro_torch/<name>-<hash>.so``
at the repository root (listed in ``.gitignore``), the compiler's report
beside it (``.log``).  The hash covers the
source text, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  Each library exposes plain C functions that take device pointers
and a stream and return the CUDA error code of their launch; no PyTorch
header is compiled.
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
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per-source extra flags: the simulator's float adds must not be
# contracted into FMAs, or rectify/latency lose bit-parity with the
# reference's float32 order.  The attention source needs none: it uses
# no CUTLASS header, and it finds libcuda's cuTensorMapEncodeTiled at run
# time (cudaGetDriverEntryPoint), so it does not link -lcuda.
EXTRA_FLAGS = {"memsim": ["-fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
# held while a library is built, loaded or has a function's types set:
# the placement service's refinement threads may reach ``load`` together
_LOAD_LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is current.
    Returns (process or None, output path, temporary path)."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per process and thread: two builders never write the same file
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile every named source in parallel (one ``nvcc`` each, all
    started together) and return per source its seconds and the
    compiler's report (``-Xptxas -v``: registers, shared memory, spills;
    for a library already built, the report saved at its build).
    Raises ``RuntimeError`` with the compiler output if a build fails."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    report, failed = {}, []
    for name, (proc, out, tmp) in started.items():
        if proc is None:
            saved = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": saved.read_text() if saved.exists()
                            else ""}
            continue
        log, _ = proc.communicate()     # every started nvcc is waited for
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn_name`` of ``csrc/<lib_name>.cu`` with its argument
    types declared and an int (CUDA error code) result."""
    with _LOAD_LOCK:
        fn = getattr(load(lib_name), fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return fn


def cuda_call(fn, like, *args):
    """fn(*args, stream) on the device of tensor ``like`` and its current
    stream: how every wrapper calls its library's C function."""
    import torch
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
