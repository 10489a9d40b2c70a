"""The native runtime (port of ``epivo_tpu/runtime/``): ctypes bindings
to a threaded libpng frame loader and the native LM baselines.

``loader.cpp`` and ``lm_ref.cpp`` are byte-equal copies of the JAX
package's sources (``tests/test_torch_runtime.py`` holds them equal): the
port may import nothing of ``epivo_tpu``, whose package imports JAX, so it
keeps its own copy of this framework-free code.

``NativeLoader`` streams decoded float32 grayscale frames from a list of
PNG paths with background decode threads and a bounded prefetch buffer.
``decode_png`` decodes one file; ``lm_refine_pose`` and ``lm_windowed``
are the single-pose and windowed native LM solvers.

The shared library is built on first use with ``g++`` (the flags of
``epivo_tpu/runtime/build.sh``) into ``build/epivo_tpu_torch/runtime/`` at
the root of the checkout; nothing is written into the source tree. libpng
comes from the first of (:func:`libpng_candidates`) that links:

- the system's (its headers and ``-lpng``), as ``build.sh`` links it;
- a ``libpng16`` shared library that an installed wheel bundles (the
  ``*.libs`` directories of Pillow or OpenCV), newest libpng first (ties
  by path), compiled against ``libpng/``: the public headers of libpng
  1.6.39 (``png.h``, ``pngconf.h``, ``pnglibconf.h``, under the libpng
  license in ``png.h``), for machines with no libpng development files.
  libpng keeps its ABI within 1.6, and the library checks the headers'
  version against its own at ``png_create_read_struct``.

A library's name is a hash of everything that went into it
(:func:`library_path`): the sources, the flags, the libpng route's include
and link flags, the bytes of the headers it was compiled against and the
path, size and time of the wheel's libpng it links. A library whose libpng
was upgraded or removed is therefore never reused: the next build makes
one for the libpng that is there.

Where it cannot be built (no compiler, no libpng), ``NativeLoader``
decodes with PIL instead, as the reference does without its library, and
says so in :attr:`NativeLoader.decoder`; :func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import site
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from epivo_tpu_torch._kernels import BUILD_DIR as _KERNEL_BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("loader.cpp", "lm_ref.cpp")
BUILD_DIR = _KERNEL_BUILD_DIR / "runtime"
PNG_HEADERS = SRC_DIR / "libpng"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lpthread",)

_lib = None
_build_error: str | None = None  # why the last build failed, if it did
build_log: str = ""  # how the library was built, when this process built it


def library_path(include: Sequence[str] = (), link: Sequence[str] = ("-lpng",)) -> Path:
    """Where the library built with one libpng route (the include and
    link flags of a :func:`libpng_candidates` entry) lives: its name
    hashes the sources, the flags, the headers in the include directories
    and the path, size and modification time of each library file linked."""
    h = hashlib.sha256("\0".join((*CXX_FLAGS, *LIBS, *include, *link)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    for d in include[1::2]:  # ["-I", dir, ...]
        for header in sorted(Path(d).glob("*.h")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
    for arg in link:
        if os.path.isfile(arg):
            st = os.stat(arg)
            h.update(f"{os.path.realpath(arg)} {st.st_size} {st.st_mtime_ns}".encode())
    return BUILD_DIR / f"libepivo_runtime_{h.hexdigest()[:16]}.so"


def libpng_version(path) -> int:
    """The version of a libpng shared library as libpng numbers it
    (``png_access_version_number``: 10658 for 1.6.58), or 0 where it
    cannot be loaded."""
    try:
        return int(ctypes.CDLL(str(path)).png_access_version_number())
    except (OSError, AttributeError):
        return 0


def bundled_libpng() -> list:
    """The libpng16 shared libraries bundled by installed wheels (their
    ``site-packages/*.libs`` directories): the newest libpng first, ties by
    path."""
    dirs = [*site.getsitepackages(), site.getusersitepackages()]
    libs = sorted(p for d in dirs for p in Path(d).glob("*.libs/libpng16*.so*"))
    return sorted(libs, key=lambda p: -libpng_version(p))


def libpng_candidates() -> list:
    """(what, include flags, link flags) of each way to get libpng, in the
    order :func:`build` tries them (see the module docstring)."""
    return [("the system's libpng", [], ["-lpng"])] + [
        (f"{lib} with the headers in {PNG_HEADERS}", ["-I", str(PNG_HEADERS)],
         [str(lib), f"-Wl,-rpath,{lib.parent}"]) for lib in bundled_libpng()]


def compile_library(out, include: list, link: list) -> subprocess.CompletedProcess:
    """One g++ run of the sources into ``out`` with the given libpng flags."""
    try:
        return subprocess.run(["g++", *CXX_FLAGS, *include,
                               *(str(SRC_DIR / s) for s in SOURCES), "-o", str(out),
                               *link, *LIBS],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"runtime build: cannot run g++: {e}") from e


def build() -> Path:
    """The library for the first libpng route of :func:`libpng_candidates`
    that has one built, else compile one with the first route that links.
    Raises RuntimeError when ``g++`` is missing or no route builds."""
    global build_log
    candidates = libpng_candidates()
    for what, include, link in candidates:
        out = library_path(include, link)
        if out.exists():
            build_log = f"cached, built with {what}"
            return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failures = []
    for what, include, link in candidates:
        out = library_path(include, link)
        # Build under a temporary name, then rename: a concurrent build
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = compile_library(tmp, include, link)
            if r.returncode == 0:
                build_log = f"built with {what}"
                os.replace(tmp, out)
                return out
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        failures.append(f"with {what}: g++ failed ({r.returncode}):\n{r.stdout}")
    raise RuntimeError("runtime build failed\n" + "\n".join(failures))


def available() -> bool:
    """Whether the library is built or can be built here (one attempt per
    process; :func:`build_error` says why it failed)."""
    global _build_error
    if _lib is not None:
        return True
    if _build_error is not None:
        return False
    try:
        _load()
        return True
    except (RuntimeError, OSError) as e:
        _build_error = str(e)
        return False


def build_error() -> str | None:
    """Why the library could not be built, or None."""
    return _build_error


def _load():
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            # A library whose system libpng went away: build anew.
            path.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(build()))
        _lib = bind(lib)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded runtime library."""
    lib.epivo_decode_png.restype = ctypes.c_void_p
    lib.epivo_decode_png.argtypes = [ctypes.c_char_p]
    lib.epivo_frame_height.restype = ctypes.c_int
    lib.epivo_frame_height.argtypes = [ctypes.c_void_p]
    lib.epivo_frame_width.restype = ctypes.c_int
    lib.epivo_frame_width.argtypes = [ctypes.c_void_p]
    lib.epivo_frame_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.epivo_frame_data.argtypes = [ctypes.c_void_p]
    lib.epivo_frame_free.argtypes = [ctypes.c_void_p]
    lib.epivo_loader_open.restype = ctypes.c_void_p
    lib.epivo_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.epivo_loader_next.restype = ctypes.c_void_p
    lib.epivo_loader_next.argtypes = [ctypes.c_void_p]
    lib.epivo_loader_close.argtypes = [ctypes.c_void_p]
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.epivo_lm_refine_pose.restype = ctypes.c_int
    lib.epivo_lm_refine_pose.argtypes = [
        dptr, dptr, dptr, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
    ]
    lib.epivo_lm_windowed.restype = ctypes.c_int
    lib.epivo_lm_windowed.argtypes = [
        dptr, ctypes.c_int,                       # T0s, Z
        ctypes.POINTER(ctypes.c_int), dptr, ctypes.c_int,  # reps, wreps, R
        dptr, dptr, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,  # p, pt, pmask, N
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        dptr, ctypes.POINTER(ctypes.c_int),       # r_norm_out, iters_out
    ]
    return lib


def _frame(lib, handle) -> np.ndarray:
    """Copy a native frame out (before it is freed)."""
    H = lib.epivo_frame_height(handle)
    W = lib.epivo_frame_width(handle)
    if H == 0 or W == 0:
        raise IOError("native decode failed mid-stream")
    buf = np.ctypeslib.as_array(lib.epivo_frame_data(handle), shape=(H, W))
    return np.array(buf, dtype=np.float32)


def decode_png(path: str) -> np.ndarray:
    """Decode one PNG (8/16-bit gray or RGB(A)) to float32 grayscale
    [H, W] in [0, 255] with the native decoder. Raises IOError on a file
    it cannot decode."""
    lib = _load()
    h = lib.epivo_decode_png(os.fsencode(path))
    if not h:
        raise IOError(f"native decode failed: {path}")
    try:
        return _frame(lib, h)
    finally:
        lib.epivo_frame_free(h)


def lm_refine_pose(T: np.ndarray, p: np.ndarray, p_t: np.ndarray,
                   lambda0: float = 1e-2, max_iters: int = 30,
                   huber_delta: float = 1e-5,
                   epsilon: float = 1e-8) -> tuple[np.ndarray, int]:
    """Native single-pose LM refine (``lm_ref.cpp``). T [4,4]; p, p_t
    [N,3] normalized matches. Returns (refined T, accepted step count)."""
    lib = _load()
    T64 = np.ascontiguousarray(T, np.float64).copy()
    p64 = np.ascontiguousarray(p, np.float64)
    pt64 = np.ascontiguousarray(p_t, np.float64)
    if T64.shape != (4, 4) or p64.ndim != 2 or p64.shape[1] != 3 or pt64.shape != p64.shape:
        raise ValueError(f"lm_refine_pose: T {T64.shape}, p {p64.shape}, p_t {pt64.shape}")
    dptr = ctypes.POINTER(ctypes.c_double)
    acc = lib.epivo_lm_refine_pose(
        T64.ctypes.data_as(dptr), p64.ctypes.data_as(dptr),
        pt64.ctypes.data_as(dptr), int(p64.shape[0]), float(lambda0), int(max_iters),
        float(huber_delta), float(epsilon),
    )
    return T64, int(acc)


def lm_windowed(T0s: np.ndarray, reps: np.ndarray, p: np.ndarray,
                p_t: np.ndarray, wreps: np.ndarray | None = None,
                pmask: np.ndarray | None = None, lambda0: float = 1e-2,
                max_iters: int = 30, huber_delta: float = 1e-5,
                epsilon: float = 1e-8):
    """Native windowed multi-zeta LM (``lm_ref.cpp``), the single-core
    counterpart of ``optim.lm.solve``.

    T0s [Z,4,4]; reps [R,2] forward spans; p/p_t [R,N,3]; wreps [R];
    pmask [R,N] bool. Returns (T_opt [Z,4,4], r_norm, accepted, iters_run).
    """
    lib = _load()
    T64 = np.ascontiguousarray(T0s, np.float64).copy()
    reps32 = np.ascontiguousarray(reps, np.int32)
    p64 = np.ascontiguousarray(p, np.float64)
    pt64 = np.ascontiguousarray(p_t, np.float64)
    Z = int(T64.shape[0])
    R = int(reps32.shape[0])
    N = int(p64.shape[1])
    if (T64.shape[1:] != (4, 4) or reps32.shape != (R, 2) or p64.shape != (R, N, 3)
            or pt64.shape != p64.shape):
        raise ValueError(f"lm_windowed: T0s {T64.shape}, reps {reps32.shape}, "
                         f"p {p64.shape}, p_t {pt64.shape}")
    if reps32.size and (reps32.min() < 0 or reps32.max() >= Z):
        raise ValueError(f"lm_windowed: a span reaches outside the {Z} zetas")
    w64 = (np.ascontiguousarray(wreps, np.float64)
           if wreps is not None else None)
    m8 = (np.ascontiguousarray(pmask, np.uint8)
          if pmask is not None else None)
    if (w64 is not None and w64.shape != (R,)) or (m8 is not None and m8.shape != (R, N)):
        raise ValueError("lm_windowed: wreps must be [R] and pmask [R, N]")
    dptr = ctypes.POINTER(ctypes.c_double)
    r_norm = ctypes.c_double(0.0)
    iters = ctypes.c_int(0)
    acc = lib.epivo_lm_windowed(
        T64.ctypes.data_as(dptr), Z,
        reps32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        w64.ctypes.data_as(dptr) if w64 is not None else None, R,
        p64.ctypes.data_as(dptr), pt64.ctypes.data_as(dptr),
        m8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if m8 is not None else None,
        N, float(lambda0), int(max_iters), float(huber_delta),
        float(epsilon), ctypes.byref(r_norm), ctypes.byref(iters),
    )
    if acc < 0:
        raise ValueError(f"lm_windowed: Z={Z} exceeds the native limit")
    return T64, float(r_norm.value), int(acc), int(iters.value)


class NativeLoader:
    """Prefetching in-order frame stream over a path list: float32
    grayscale [H, W] frames, decoded by ``n_workers`` native threads into
    a buffer of ``capacity`` frames. :attr:`decoder` is "native", or "pil"
    where the library cannot be built (then frames decode one by one with
    PIL, as the reference's loader does without its library)."""

    def __init__(self, paths: Sequence[str], n_workers: int = 2,
                 capacity: int = 8):
        self._paths = [os.fspath(p) for p in paths]
        self._n_workers = n_workers
        self._capacity = capacity
        self.decoder = "native" if available() else "pil"

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.decoder == "pil":
            from PIL import Image

            for p in self._paths:
                with Image.open(p) as im:
                    yield np.asarray(im.convert("L"), dtype=np.float32)
            return
        lib = _load()
        handle = lib.epivo_loader_open(
            "\n".join(self._paths).encode(), self._n_workers, self._capacity
        )
        if not handle:
            raise IOError("loader_open failed")
        try:
            while True:
                fr = lib.epivo_loader_next(handle)
                if not fr:
                    break
                # The loader owns the frame until the next call: copy it out.
                yield _frame(lib, fr)
        finally:
            lib.epivo_loader_close(handle)
