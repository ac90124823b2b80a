"""A reader and writer of the safetensors format, the port's own (it does not
need the ``safetensors`` package).

A file is an 8-byte little-endian header length ``n``, then ``n`` bytes of
JSON (padded with spaces to a multiple of 8) mapping each tensor's name to
``{"dtype", "shape", "data_offsets": [begin, end]}``, with an optional
``"__metadata__"`` map of strings, then the tensors' raw little-endian bytes,
each at its offsets counted from the end of the header. bfloat16 has no
numpy dtype: its bytes go through a ``uint16`` view, as in ``bridge.py``.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> torch dtype
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_ALIGN = 8

if sys.byteorder != "little":      # the format's bytes are little-endian
    raise ImportError("safetensors_io reads and writes on little-endian "
                      "hosts only")


def cpu_tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor on any device, or a numpy array,
    bfloat16 included), contiguous."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    a = np.array(x, order="C")       # a copy; keeps a 0-d array 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _raw(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes as a uint8 numpy array (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (name -> tensor or numpy array) to ``path``, in
    name order."""
    ts = {k: cpu_tensor(v) for k, v in sorted(tensors.items())}
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    at = 0
    for name, t in ts.items():
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % _ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in ts.values():
            f.write(_raw(t))


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of ``path`` into CPU tensors with the dtypes the
    file names, each read straight into its own memory."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data_bytes = f.seek(0, 2) - 8 - n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise TypeError(f"{path}: {name} has dtype {info['dtype']}, "
                                "which the reader does not take")
            begin, end = info["data_offsets"]
            t = torch.empty(tuple(info["shape"]), dtype=dtype)
            if (not 0 <= begin <= end <= data_bytes
                    or end - begin != t.numel() * t.element_size()):
                raise ValueError(f"{path}: {name} at {begin}..{end} does not "
                                 f"hold {tuple(t.shape)} {info['dtype']} in "
                                 f"{data_bytes} bytes")
            f.seek(8 + n + begin)
            if f.readinto(memoryview(_raw(t))) != end - begin:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = t
    return out
