"""ctypes bindings of the native host IO runtime (``qdml_tpu/runtime/native_io.py``).

The library is the port's own copy of the C++ source,
``qdml_tpu_torch/csrc/qdml_io.cpp``, and gives three host-side primitives:

- :class:`NativeNpyFile`: zero-copy mmapped ``.npy`` access (the header
  parsed in C++, the data a numpy view of the mapping);
- :func:`gather_rows`: multithreaded batch assembly from shuffled row
  indices into one contiguous array (the GIL is released for the copy);
- :class:`PrefetchPipeline`: an async slot ring whose C++ worker threads
  fill the next batches while the current one is consumed.

The library is compiled with ``g++`` at first use into
``build/qdml_tpu_torch/`` beside the package (``QDML_NATIVE_DIR`` names
another directory), keyed by a hash of the source and the flags, and never
beside its source. Without ``g++`` or a loadable library every entry point
degrades to numpy with the same results, as the JAX package's does; each
says which it took (``is_native``, :func:`native_available`), and
:data:`build_error` keeps why the build failed. A caller that must have the
native path checks those.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

from qdml_tpu_torch.utils import lockdep

SRC = Path(__file__).resolve().parents[1] / "csrc" / "qdml_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qdml_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOCK = lockdep.Lock("native_io:_LOCK")
_LIB: ctypes.CDLL | None = None
_TRIED = False
#: why the library could not be built or loaded (None when it was, or
#: before the first use)
build_error: str | None = None

_DTYPES = {
    ("f", 4): np.float32,
    ("f", 8): np.float64,
    ("c", 8): np.complex64,
    ("c", 16): np.complex128,
    ("i", 4): np.int32,
    ("i", 8): np.int64,
    ("u", 4): np.uint32,
    ("u", 8): np.uint64,
}


def library_path() -> Path:
    """Where the built library lives: ``QDML_NATIVE_DIR`` or
    ``build/qdml_tpu_torch/``, named by a hash of the source and flags."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    out_dir = Path(os.environ.get("QDML_NATIVE_DIR") or BUILD_DIR)
    return out_dir / f"libqdml_io-{digest.hexdigest()[:16]}.so"


def _build_lib() -> Path:
    """The library, compiled when missing (into a temporary name, then
    renamed: a concurrent loader never sees half a file). Raises
    ``RuntimeError`` with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, build_error
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build_lib()))  # lint: disable=blocking-under-lock(one-time lazy build: _LOCK makes the native compile exactly-once; every later caller needs the library and must wait for it regardless)
        except (RuntimeError, OSError) as e:
            build_error = str(e)
            return None
        lib.qdml_npy_open.restype = ctypes.c_void_p
        lib.qdml_npy_open.argtypes = [ctypes.c_char_p]
        lib.qdml_npy_info.restype = ctypes.c_int
        lib.qdml_npy_info.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char),
        ]
        lib.qdml_npy_data.restype = ctypes.c_void_p
        lib.qdml_npy_data.argtypes = [ctypes.c_void_p]
        lib.qdml_npy_close.argtypes = [ctypes.c_void_p]
        lib.qdml_gather_rows.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.qdml_prefetch_create.restype = ctypes.c_void_p
        lib.qdml_prefetch_create.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.c_int,
        ]
        lib.qdml_prefetch_submit.restype = ctypes.c_int
        lib.qdml_prefetch_submit.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
        ]
        lib.qdml_prefetch_wait.restype = ctypes.c_int
        lib.qdml_prefetch_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.qdml_prefetch_buffer.restype = ctypes.c_void_p
        lib.qdml_prefetch_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.qdml_prefetch_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.qdml_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True when the C++ library could be built and loaded."""
    return _load() is not None


class NativeNpyFile:
    """mmapped ``.npy`` file; ``.array`` is a zero-copy read-only numpy view.

    Falls back to ``np.load(mmap_mode='r')`` when the native library is
    unavailable or cannot read the file's dtype (``is_native`` is then
    False): the same values either way.
    """

    def __init__(self, path: str):
        self.path = path
        self._handle = None
        self._lib = _load()
        if self._lib is not None:
            h = self._lib.qdml_npy_open(path.encode())
            if h:
                self._handle = h
                shape = (ctypes.c_long * 8)()
                ndim = ctypes.c_int()
                itemsize = ctypes.c_int()
                tch = ctypes.c_char()
                self._lib.qdml_npy_info(
                    h, shape, ctypes.byref(ndim), ctypes.byref(itemsize), ctypes.byref(tch)
                )
                dtype = _DTYPES.get((tch.value.decode(), itemsize.value))
                if dtype is None:
                    self._lib.qdml_npy_close(h)
                    self._handle = None
                else:
                    shp = tuple(shape[i] for i in range(ndim.value))
                    n = int(np.prod(shp)) if shp else 1
                    buf_t = ctypes.c_char * (n * itemsize.value)
                    buf = buf_t.from_address(self._lib.qdml_npy_data(h))
                    # the view's .base chain keeps this object (and so the
                    # mapping) alive: a bare from_address buffer holds only
                    # the raw pointer, and unmapping under a reachable array
                    # would be a use after munmap
                    buf._qdml_owner = self
                    view = np.frombuffer(buf, dtype=dtype).reshape(shp)
                    view.flags.writeable = False  # a PROT_READ mapping
                    self.array = view
        if self._handle is None:
            self.array = np.load(path, mmap_mode="r")

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def close(self) -> None:
        if self._handle is not None:
            self.array = None  # drop the view before unmapping
            self._lib.qdml_npy_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # lint: disable=broad-except(__del__ at interpreter shutdown: module globals may already be torn down)
            pass


def gather_rows(
    src: np.ndarray, indices: Sequence[int] | np.ndarray, n_threads: int = 4
) -> np.ndarray:
    """``src[indices]`` into a fresh contiguous array, by C++ threads when
    the library is there (the GIL released for the whole copy)."""
    src = np.ascontiguousarray(src) if not src.flags["C_CONTIGUOUS"] else src
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(src[idx])
    row_shape = src.shape[1:]
    row_bytes = int(np.prod(row_shape, dtype=np.int64)) * src.itemsize
    out = np.empty((len(idx),) + row_shape, dtype=src.dtype)
    lib.qdml_gather_rows(
        src.ctypes.data_as(ctypes.c_void_p),
        row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        len(idx),
        out.ctypes.data_as(ctypes.c_void_p),
        int(n_threads),
    )
    return out


class PrefetchPipeline:
    """Async batch assembly over a row-major source array.

    ``submit(indices)`` queues a batch fill on the C++ worker pool and
    returns a ticket; ``get(ticket)`` blocks until that batch is ready and
    returns a numpy view of the slot buffer, valid until
    ``release(ticket)``. With ``n_slots >= 2`` the next batch fills while
    the current one is consumed. Without the library, a numpy copy per
    ticket keeps the same API.
    """

    def __init__(
        self,
        src: np.ndarray,
        batch: int,
        n_slots: int = 3,
        n_threads: int = 4,
    ):
        if not src.flags["C_CONTIGUOUS"]:
            raise ValueError("prefetch source must be C-contiguous")
        self.src = src
        self.batch = batch
        self.row_shape = src.shape[1:]
        self.row_bytes = int(np.prod(self.row_shape, dtype=np.int64)) * src.itemsize
        self._lib = _load()
        self._fallback: dict[int, np.ndarray] = {}
        self._counts: dict[int, int] = {}
        self._next_ticket = 0
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.qdml_prefetch_create(
                src.ctypes.data_as(ctypes.c_void_p),
                self.row_bytes,
                int(n_slots),
                int(batch),
                int(n_threads),
            )

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def submit(self, indices: np.ndarray) -> int:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if len(idx) > self.batch:
            raise ValueError(f"{len(idx)} rows exceed the pipeline's batch of {self.batch}")
        if self._handle is None:
            t = self._next_ticket
            self._next_ticket += 1
            self._fallback[t] = np.ascontiguousarray(self.src[idx])
            return t
        slot = self._lib.qdml_prefetch_submit(
            self._handle,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx),
        )
        if slot < 0:
            raise RuntimeError("no free prefetch slot: release() consumed batches first")
        self._counts[slot] = len(idx)
        return slot

    def get(self, ticket: int) -> np.ndarray:
        if self._handle is None:
            return self._fallback[ticket]
        self._lib.qdml_prefetch_wait(self._handle, ticket)
        addr = self._lib.qdml_prefetch_buffer(self._handle, ticket)
        n = self._counts[ticket]
        buf = (ctypes.c_char * (n * self.row_bytes)).from_address(addr)
        return np.frombuffer(buf, dtype=self.src.dtype).reshape((n,) + self.row_shape)

    def release(self, ticket: int) -> None:
        if self._handle is None:
            self._fallback.pop(ticket, None)
        else:
            self._lib.qdml_prefetch_release(self._handle, ticket)
            # drop the count: a stale ticket must not read a reused slot's
            # buffer at the wrong length
            self._counts.pop(ticket, None)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.qdml_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # lint: disable=broad-except(__del__ at interpreter shutdown: module globals may already be torn down)
            pass
