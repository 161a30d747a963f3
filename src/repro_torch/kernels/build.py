"""Build the CUDA kernels into one shared library and load it with ctypes.

The sources in ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` compiles each in seconds.  The first call to
:func:`library` compiles every source at once (one ``nvcc`` process per
file, started together), links them into ``_build/librepro_torch_<hash>.so``
and loads it.  The hash covers the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.  ``nvcc -Xptxas -v`` output (each
kernel's registers, shared memory and spills) is kept beside the library;
:func:`ptxas_report` returns it.

Nothing is built at import time: this module imports on hosts without a
CUDA toolkit, where only the plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
SOURCES = ("decode_attention.cu", "flash_attention.cu")
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
# argtypes of each exported C entry; every pointer and the stream are void*
SIGNATURES = {
    "repro_decode_attention": [_VOID_P] * 7 + [_INT] * 8 + [_VOID_P],
    "repro_paged_decode_attention": [_VOID_P] * 7 + [_INT] * 8 + [_VOID_P],
    "repro_flash_attention": [_VOID_P] * 4 + [_INT] * 9 + [_VOID_P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def _report_path() -> Path:
    return BUILD_DIR / f"ptxas_{_digest()}.log"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = BUILD_DIR / f"{out.name}.{tag}.tmp"
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    for _, obj, _ in procs:
        obj.unlink()
    _report_path().write_text("\n".join(logs))
    os.replace(tmp, out)
    return out


def ptxas_report() -> str:
    """``nvcc -Xptxas -v`` output of the current build ('' if none)."""
    path = _report_path()
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
