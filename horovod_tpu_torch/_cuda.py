"""Builds and loads the port's CUDA kernels (``csrc/*.cu``) on first use.

Counterpart of ``horovod_tpu/native.py`` in role only: that module builds
the host C++ core with ``make`` and loads it with ctypes; this one runs
``nvcc`` for Hopper (``sm_90a``) over ``horovod_tpu_torch/csrc/`` into
``build/horovod_tpu_torch/`` at the root of the checkout and loads the
result with ctypes. Each ``.cu`` source compiles in its own ``nvcc``
process, all started together, and one link makes the library. The
library's name carries a hash of the sources and flags, so an edited
source gets a new build; a file lock keeps concurrent processes from
building the same library twice.

The C functions take every pointer and the stream as ``c_void_p`` and
return a ``cudaError_t``; :func:`check` raises on anything but success.
Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "horovod_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the exported C functions. ``dtype`` is 0 fp32, 1
# bf16, 2 fp16; ``scale`` multiplies the logits: 1/sqrt of the head dim
# before the wrapper zero-padded D.
_SIGNATURES = {
    # dtype, q, k, v, o, m, l, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream
    "hvdt_flash_fwd": [_I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, dq, B, H, Sq, Sk, D, q_off, k_off,
    # causal, scale, stream
    "hvdt_flash_dq": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, dk, dv, B, H, Sq, Sk, D, q_off,
    # k_off, causal, scale, stream
    "hvdt_flash_dkv": [_I] + [_P] * 8 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, o, m, l, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream
    "hvdt_flash_fwd_sm90": [_I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, o, m, l, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream
    "hvdt_flash_fwd_stream": [_I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    # q, k, v, o, m, l, scratch, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream (fp32 only)
    "hvdt_flash_fwd_tf32": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k, v, o, m, l, scratch, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream (fp32 at D 16 and 32 only: the narrow tf32 forward)
    "hvdt_flash_fwd_tf32_narrow": [_P] * 7 + [_I] * 8 + [_F, _P],
    # q, k, v, scratch, B, H, Sq, Sk, D, stream (fp32 only: the tf32
    # forward's pre-pass alone)
    "hvdt_flash_fwd_tf32_split": [_P] * 4 + [_I] * 5 + [_P],
    # D: the columns of O a CTA of the tf32 forward owns there (its build)
    "hvdt_flash_fwd_tf32_part": [_I],
    # dtype, q, k, v, do, lse, delta, dq, B, H, Sq, Sk, D, q_off, k_off,
    # causal, scale, stream
    "hvdt_flash_dq_sm90": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, dq, B, H, Sq, Sk, D, q_off, k_off,
    # causal, scale, stream
    "hvdt_flash_dq_stream": [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, dk, dv, B, H, Sq, Sk, D, q_off,
    # k_off, causal, scale, stream
    "hvdt_flash_dkv_sm90": [_I] + [_P] * 8 + [_I] * 8 + [_F, _P],
    # dtype, q, k, v, do, lse, delta, dk, dv, B, H, Sq, Sk, D, q_off,
    # k_off, causal, scale, stream
    "hvdt_flash_dkv_stream": [_I] + [_P] * 8 + [_I] * 8 + [_F, _P],
    # q, k, v, do, scratch, B, H, Sq, Sk, D, stream (fp32 only: the tf32
    # backward's pre-pass, which every tf32 dq and dk/dv build reads)
    "hvdt_flash_bwd_tf32_split": [_P] * 5 + [_I] * 5 + [_P],
    # scratch, lse, delta, dq, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream
    "hvdt_flash_dq_tf32": [_P] * 4 + [_I] * 8 + [_F, _P],
    # D: the columns of dQ a CTA of the tf32 dq owns there (its build)
    "hvdt_flash_dq_tf32_part": [_I],
    # scratch, lse, delta, dk, dv, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream
    "hvdt_flash_dkv_tf32": [_P] * 5 + [_I] * 8 + [_F, _P],
    # D: the columns of dK and dV a CTA of the tf32 dk/dv owns there (its
    # build)
    "hvdt_flash_dkv_tf32_part": [_I],
    # scratch, lse, delta, dq, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream (fp32 at D 16 and 32 only: the narrow tf32 dq)
    "hvdt_flash_dq_tf32_narrow": [_P] * 4 + [_I] * 8 + [_F, _P],
    # scratch, lse, delta, dk, dv, B, H, Sq, Sk, D, q_off, k_off, causal,
    # scale, stream (fp32 at D 16 and 32 only: the narrow tf32 dk/dv)
    "hvdt_flash_dkv_tf32_narrow": [_P] * 5 + [_I] * 8 + [_F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    cu = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found at {path}: the port's kernels are built with "
            "the CUDA toolkit (set CUDA_HOME)")
    return path


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Runs the commands concurrently; raises with the output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(c)}):\n{out}")


def _build(so_path: str, cu) -> None:
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + ".o") for s in cu]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
              for s, o in zip(cu, objs)])
    tmp = so_path + f".tmp{os.getpid()}"
    _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]])
    os.replace(tmp, so_path)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this checkout has no build of
    the current sources."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        cu, hdr = _sources()
        so_path = os.path.join(BUILD_DIR,
                               f"libhvdt_flash_{_digest(cu + hdr)}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock_fh:
            fcntl.flock(lock_fh, fcntl.LOCK_EX)
            if not os.path.exists(so_path):
                t0 = time.perf_counter()
                _build(so_path, cu)
                build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hvdt_error_string.argtypes = [ctypes.c_int]
        lib.hvdt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raises if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = _lib.hvdt_error_string(err).decode() if _lib else "?"
        raise RuntimeError(f"{what} failed to launch: CUDA error {err} "
                           f"({msg})")
