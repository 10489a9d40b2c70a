"""Build and bind the hand-written CUDA kernels under ``csrc/``.

The sources are compiled by ``nvcc``, one process per source, all started
together, and linked into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers: such a build takes seconds,
where one through ``torch.utils.cpp_extension.load`` takes minutes). Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises on a non-zero status.

The library goes into ``build/epivo_tpu_torch/`` at the root of the
checkout, keyed by a hash of the sources and flags, and is built on first
use. Nothing here runs at import time, so CPU-only machines import the
package without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "epivo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every launching entry point returns a cudaError_t as int.
_SIGNATURES = {
    # img, out, B, H, W, threshold, nms, stream
    "epivo_fast_score": (_P, _P, _I, _I, _I, _F, _I, _P),
    # img, cand_val, cand_idx, B, H, W, threshold, nms, stream
    "epivo_fast_candidates": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    # img, oy, ox, out, B, H, W, K, S, stream
    "epivo_extract_windows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # tgt, T, Ix, Iy, q0, q_out, err, K, S, win, iters, eps, hi, stream
    "epivo_lk_iterate": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
    # src, tgt, pt_src, guess, new_guess, ok, err, B, H, W, K, S, win,
    # chunk_iters, n_chunks, eps, min_eig, hi, stream
    "epivo_track_level": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _F, _F, _F, _P),
    # S, win -> bytes of dynamic shared memory per block of the level kernel
    "epivo_track_level_smem": (_I, _I),
}

_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of the build this process made (ptxas -v)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the kernels "
                           "are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libepivo_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    # Build under a temporary name, then rename: concurrent builders never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objs:
        try:
            procs = [(src, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", os.path.join(objs, src.stem + ".o"),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                for src in sources]
            logs, failed = [], []
            for src, proc in procs:
                logs.append(proc.communicate()[0])
                if proc.returncode != 0:
                    failed.append(f"{src.name} ({proc.returncode})")
            if not failed:
                r = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp,
                                    *(os.path.join(objs, s.stem + ".o") for s in sources)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
                logs.append(r.stdout)
                if r.returncode != 0:
                    failed.append(f"link ({r.returncode})")
            build_log = "".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.epivo_error_string.argtypes = (ctypes.c_int,)
        handle.epivo_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if status != 0:
        msg = lib().epivo_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({msg})")


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
