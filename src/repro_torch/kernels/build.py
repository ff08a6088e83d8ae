"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/torch_kernels/<name>-<hash>.so`` at the repository root
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), loaded
with ``ctypes``. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited kernel rebuilds and an
unchanged one loads from disk. :func:`build_all`
starts one ``nvcc`` per source, all at once. No ``--use_fast_math``:
the quantizer's divisions must stay IEEE-rounded.

Nothing is built or loaded at import time; the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("quant_matmul", "blockwise_quant", "flash_attention",
           "lora_matmul", "lora_gemv", "selective_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, object] = {}
# nvcc's ptxas report (registers, shared memory, spills) per kernel source
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns the seconds each
    build took (0 for a kernel already on disk); raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = so_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)           # atomic: a reader never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(so_path(name)))
    return lib


def function(name: str, symbol: str, argtypes):
    """A C entry point with its argument types declared; pointers and the
    stream are ``c_void_p`` so ctypes never truncates them to 32 bits."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``): a
    refused launch never runs, and a later synchronize would not say."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
