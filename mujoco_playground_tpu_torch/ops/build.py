"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/`` beside the package, named by a
hash of every file in ``csrc/`` and the flags, so an edit rebuilds and an
unchanged tree loads what is there.  ``build()`` starts one ``nvcc`` per
missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("step_kernel.cu", "step_kernel_dr.cu", "lidar_kernel.cu",
           "newton_kernel.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# K1, K1e and K2 round every product and sum on its own, as their plain
# twins' elementwise ops do.  Contracted into fused multiply-adds, K1's and
# K1e's float32 steps part from the twins' beyond the tolerance on about 1%
# of the envs per step of wall-contact states, where float32 is
# ill-conditioned (PERF.md; scripts/torch_k1_wall_flips.py shows it on the
# host); K2's beams part by up to 4.8e-5 m on PointMaze_Medium-v3's frames,
# where long beams graze its walls, while K1's fused scan of the same
# frames (the same lidar.cuh without contractions) stays within 1e-6.
SOURCE_FLAGS = {"step_kernel.cu": ("-fmad=false",),
                "step_kernel_dr.cu": ("-fmad=false",),
                "lidar_kernel.cu": ("-fmad=false",)}

_LOADED: dict = {}


def header_dims() -> dict:
    """The compile-time robot dimensions of ``csrc/robot_dims.h``."""
    text = (CSRC / "robot_dims.h").read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define\s+(\w+)\s+(\d+)\b", text, re.M)}


@functools.cache
def _digest() -> str:
    """Hash of the kernel sources and flags, read once per process (every
    launch resolves its library through it)."""
    h = hashlib.sha256(f"{NVCC_FLAGS} {sorted(SOURCE_FLAGS.items())}".encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest()}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build(sources=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source in parallel.
    Returns {source: nvcc's output (ptxas register and spill report)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs, procs = {}, {}
    try:
        for src in sources:
            out = library_path(src)
            log = out.with_suffix(".log")
            if out.exists():
                logs[src] = log.read_text() if log.exists() else ""
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), "-o",
                   str(tmp), str(CSRC / src)]
            procs[src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, log)
        for src, (proc, tmp, out, log) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
            log.write_text(text)
            os.replace(tmp, out)
            logs[src] = text
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if missing."""
    path = library_path(source)
    lib = _LOADED.get(path)
    if lib is None:
        if not path.exists():
            build((source,))
        lib = ctypes.CDLL(str(path))
        _LOADED[path] = lib
    return lib


def upload_constants(lib, prefix: str, blob) -> None:
    """Copy a model's constant block into the library's ``__constant__``
    memory, unless it is the block already there."""
    if getattr(lib, "current_constants", None) is blob:
        return
    size = getattr(lib, f"{prefix}_const_size")
    size.restype = ctypes.c_size_t
    if size() != ctypes.sizeof(blob):
        raise RuntimeError(f"{prefix}: constant block layout differs between "
                           f"Python ({ctypes.sizeof(blob)} B) and CUDA "
                           f"({size()} B)")
    setc = getattr(lib, f"{prefix}_set_constants")
    setc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    setc.restype = ctypes.c_int
    err = setc(ctypes.addressof(blob), ctypes.sizeof(blob))
    if err != 0:
        raise RuntimeError(f"{prefix}_set_constants failed: CUDA error {err}")
    lib.current_constants = blob
