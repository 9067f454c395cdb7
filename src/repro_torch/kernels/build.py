"""Build and load the port's CUDA kernels.

Every kernel library is compiled from the `.cu` sources under
`repro_torch/kernels/*/csrc/` with `nvcc` into a shared library with a plain
C interface, at first use, and loaded with `ctypes`.  Libraries go into
`build/repro_torch/` at the root of the checkout (listed in `.gitignore`),
named by a hash of their sources and flags, so a stale library is never
loaded.  A missing `nvcc` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its sources and the headers they include, relative to
# repro_torch/kernels/ (all of them go into the library's hash; the `.cu`
# files go to nvcc)
LIBRARIES = {
    "rloo": ("rloo/csrc/rloo.cu", "csrc/reduction.cuh"),
    "rloo_q": ("rloo/csrc/rloo_q.cu", "csrc/reduction.cuh"),
    "robust": ("robust/csrc/robust.cu", "csrc/reduction.cuh"),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu",),
    "flash_attention_bf16": ("flash_attention/csrc/flash_attention_bf16.cu",
                             "flash_attention/csrc/wgmma.cuh"),
    "selective_scan": ("selective_scan/csrc/selective_scan.cu",),
}

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}       # library -> nvcc's output (ptxas -v)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((KERNELS_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> float:
    """Compile every library that is not built yet, one `nvcc` per library,
    all started together.  Returns the wall seconds the builds took."""
    names = tuple(LIBRARIES) if names is None else tuple(names)
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(KERNELS_DIR / s) for s in LIBRARIES[name]
                 if s.endswith(".cu"))]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
