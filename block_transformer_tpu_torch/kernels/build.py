"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` at the repository root
(``build/`` is git-ignored), for ``sm_90a`` (Hopper). The hash covers the
source, the shared headers and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing is compiled when a module is imported: the first
call of a wrapper on a CUDA tensor builds its kernel, and ``build_all``
starts one ``nvcc`` per source, all at once, to build them in parallel.

Every C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after the launch; ``check`` raises when that
is not 0. No kernel has a backward: every wrapper first calls
``no_backward``, which refuses inputs that require grad under grad mode.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # name -> nvcc output (ptxas register lines)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names) -> dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: seconds} of the builds run."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {}
    for name, (proc, _, _) in procs.items():   # wait for every nvcc first
        build_logs[name], _ = proc.communicate()
        took[name] = time.perf_counter() - t0
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{build_logs[name]}")
        os.replace(tmp, out)
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` (None skipped) requires grad:
    autograd would want a backward through the op."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(what: str, *tensors) -> None:
    """Raise when autograd would need a backward of kernel ``what``: its
    output is written through a raw pointer and has no ``grad_fn``, so a loss
    downstream would get no gradient through it, silently. Every wrapper
    calls this first, on the CPU too, so both devices refuse the same
    calls; run inference under ``torch.no_grad()``, and training through
    the plain ops (``ops.attention.attention`` does so under autograd)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, but the kernel has no backward "
            "(call it under torch.no_grad(), or use the plain op to train)")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raw_stream(dev: int) -> int:
    """The current stream's raw handle on device ``dev``:
    ``torch.cuda.current_stream()`` costs ~4 us of host time a call, as much
    as a kernel at decode."""
    import torch
    return torch._C._cuda_getCurrentRawStream(dev)


@functools.cache
def sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> (float32 partial sums, int32 arrival counters):
# the scratch of the kernels that split their work over blocks and merge it
# in the same launch (K1/K4's split K, K2's split cache), grown as needed
# and shared by the launches of one stream, which run in order. The kernels
# leave every counter at zero.
_scratch: dict = {}


def scratch(dev: int, stream: int, floats: int, counters: int):
    """(float32 [>= floats], int32 [>= counters] zeros) for ``stream``."""
    import torch
    ws, ctr = _scratch.get((dev, stream), (None, None))
    if ws is None or ws.numel() < floats or ctr.numel() < counters:
        floats = max(floats, 0 if ws is None else ws.numel())
        counters = max(counters, 0 if ctr is None else ctr.numel())
        device = torch.device("cuda", dev)
        ws = torch.empty(floats, dtype=torch.float32, device=device)
        ctr = torch.zeros(counters, dtype=torch.int32, device=device)
        _scratch[(dev, stream)] = (ws, ctr)
    return ws, ctr
