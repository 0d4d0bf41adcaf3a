"""Build ``kernels/csrc/*.cu`` with nvcc into one shared library, load it.

The sources have a plain C interface (no PyTorch headers), so nvcc builds
them in seconds: one compile per source, all started together, then one
link.  The library lands in ``kernels/_build/``
(git-ignored) under a name that carries the hash of the sources and flags:
an edited source builds anew, an unchanged one loads the existing file.
Nothing is built at import; the first kernel launch calls ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _U32, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64
_F = ctypes.c_float
# C entry point -> argument types; every pointer and the stream are
# c_void_p (ctypes would otherwise pass a 32-bit int and cut them), and a
# float is c_float (ctypes would otherwise pass a Python float as a double).
SIGNATURES = {
    "bp_mask": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_mask_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_mask_wide": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_mask_tall": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_mask_deep": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_mask_xwide": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bp_apply_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_apply_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_apply_tall": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_apply_deep": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_apply_xwide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_clear": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bp_clear_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_clear_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_clear_tall": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_clear_deep": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_clear_xwide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "bp_legality": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bp_legality_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _U64, _I, _I, _P],
    "bp_legality_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_legality_tall": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_legality_deep": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_legality_xwide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bp_packed_mask": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_words": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_apply_tall": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bp_packed_apply_general": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bp_packed_apply_general_pass": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P],
    "bp_packed_mask_tall": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_mask_general": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_mask_general_pick": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_words_tall": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_words_general": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "bp_packed_words_general_pick": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _P],
    "bp_packed_tail": [*[_P] * 24, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "bp_packed_tail_ring": [*[_P] * 24, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "bp_packed_tail_parts": [*[_P] * 24, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                             _P],
    "bp_packed_unpack": [_P, _P, _I, _I, _I, _I, _P],
    "bp_deal": [_P, _P, _U32, _I, _I, _I, _P, _I, _P],
    "bp_uniform_legal": [_P, _U32, _I, _P, _P, _I, _I, _P],
    "bp_words_select": [_P, _U32, _I, _P, _P, _I, _I, _I, _P],
    "bp_words_select_lanes": [_P, _U32, _I, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return path


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbp_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library for them exists; return it.

    Each ``*.cu`` compiles to an object in its own nvcc process, all
    started together; one more nvcc links them.  The compilers' stderr
    (``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = so.with_name(f"{tag}.tmp")
    try:
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        logs = [p.communicate()[1] for p in procs]
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    so.with_suffix(".log").write_text("".join(logs) + res.stderr)
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def resolve_device(device) -> torch.device:
    """``torch.device`` with an explicit index for CUDA ("cuda" ->
    "cuda:<current>"), so it compares equal to a tensor's device.  Asked
    for CUDA on a machine without a card it raises: nothing falls back to
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
