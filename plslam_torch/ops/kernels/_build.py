"""One build step for every hand-written kernel of the port.

`build()` compiles each `plslam_torch/csrc/*.cu` with nvcc for sm_90a into
an object file (one nvcc process per source, all started together), links
them into `plslam_torch/_build/libplslam_kernels_<hash>.so` against
cuSOLVER (`eigh.cu` calls its drivers) and returns its path. The hash covers
the sources, the nvcc path and the flags, so a build is reused until one of
them changes. `lib()` loads that library once; each kernel module
(`lk.py`, `hamming.py`, `eigh.py`) binds its own C symbol from it, once, and
keeps the bound function.
The sources have a plain C interface and include no PyTorch header, so a
build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-lcusolver"]

_LIB = None
_LOCK = threading.Lock()


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile and link `csrc/*.cu` (once per content); returns the library
    path. `<library>.log` holds nvcc's `-Xptxas -v` lines of every source."""
    srcs = sources()
    nvcc = _nvcc()
    link_flags = [*LINK_FLAGS, "-Xlinker", "-rpath", "-Xlinker",
                  os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")]
    h = hashlib.sha256("\0".join([nvcc, *NVCC_FLAGS, *link_flags]).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"libplslam_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = []
    try:
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(s)} ({p.returncode}):\n{out}")
            logs.append(f"[{os.path.basename(s)}]\n{out.strip()}")
        tmp = f"{so}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs, *link_flags], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)
    with open(so + ".log", "w") as fh:
        fh.write("\n".join(logs) + "\n")
    return so


def lib() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(build())
    return _LIB


def bind(name: str, argtypes: tuple):
    """The C function `name` of the library, returning an int (a cudaError).
    Each kernel module binds its entry once and keeps it."""
    fn = getattr(lib(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn
