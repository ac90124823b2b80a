"""ctypes binding and on-demand build of the native document packer (port of
``block_transformer_tpu/data/native.py``).

``get_packer()`` builds ``csrc/packer.cpp`` (the repo's C++ packer, shared
with the JAX package and left as it is) with ``g++`` on first use into
``build/torch_packer/libpacker.so`` and loads it, or returns None when
there is no source or no toolchain; ``PackedDataset.get_batch`` then takes
the numpy mapping, which gives the same batches, and records the route it
took in ``last_route``. This is host code: it fills the batch on the CPU
with one thread per sample range.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "packer.cpp")
_SO = os.path.join(_ROOT, "build", "torch_packer", "libpacker.so")

_lock = threading.Lock()
_lib = None
_tried = False

_DTYPE_CODES = {np.dtype(np.uint16): 0, np.dtype(np.int32): 1,
                np.dtype(np.int64): 2, np.dtype(np.uint8): 3}


def _build() -> Optional[str]:
    if not os.path.isfile(_SRC):
        return None
    if os.path.isfile(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # build to a name of this process's own, then rename: processes that
    # build at once never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, _SO)
    return _SO


def get_packer():
    """The loaded library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.pack_batch.restype = ctypes.c_int
        lib.pack_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,                    # token_data, dtype
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def pack_batch_native(ds, starts: np.ndarray, n_threads: int = 0):
    """(ids int32 [B, L], att int8 [B, L]) from the native packer, for
    ``ds`` (a ``data.packing.PackedDataset``) at padded-corpus offsets
    ``starts``; None when the library is unavailable or the token dtype is
    not one it reads."""
    lib = get_packer()
    if lib is None:
        return None
    token_data = np.ascontiguousarray(ds.corpus.token_data)
    code = _DTYPE_CODES.get(token_data.dtype)
    if code is None:
        return None
    doc_lengths = np.ascontiguousarray(ds.corpus.document_lengths, np.int64)
    doc_indices = np.ascontiguousarray(ds.corpus.document_indices, np.int64)
    left_pad = np.ascontiguousarray(ds.left_pad, np.int64)
    pstarts = np.ascontiguousarray(ds.padded_doc_starts, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    B = len(starts)
    ids = np.empty((B, ds.max_length), np.int32)
    att = np.empty((B, ds.max_length), np.int8)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    pad = ds.pad_token if ds.pad_token is not None else ds.eos_token
    rc = lib.pack_batch(
        token_data.ctypes.data_as(ctypes.c_void_p), code,
        _i64ptr(doc_lengths), _i64ptr(doc_indices), _i64ptr(left_pad),
        _i64ptr(pstarts), len(doc_lengths), ds.padded_total_length,
        ds.eos_token, pad, _i64ptr(starts), B, ds.max_length,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        att.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n_threads)
    if rc != 0:
        return None
    return ids, att
