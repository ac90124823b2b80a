"""Megatron/pythia-format memory-mapped token dataset (.bin/.idx) (port of
``block_transformer_tpu/data/mmap_dataset.py``).

A fresh reader/writer for the indexed-dataset binary format the reference
consumes (util/mmap_dataset.py reads the same layout, which the Pythia
deduped-Pile "idxmaps" ship in):

``<name>.idx``: header ``MMIDIDX\\x00\\x00`` (9 bytes) | version u64 (=1) |
dtype code u8 | sequence_count u64 | document_count u64 | sizes i32[seq] |
pointers i64[seq] (byte offsets into .bin) | doc_idx i64[doc_count]
(sequence index of each document start).

``<name>.bin``: the raw token array.

Reads are zero-copy ``np.memmap`` views; the host feeds batches from here
without further native dependencies.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
    5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class MMapIndexedDataset:
    """Zero-copy reader. ``ds[i]`` returns document i's token array."""

    def __init__(self, path_prefix: str):
        self.path_prefix = path_prefix
        with open(path_prefix + ".idx", "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(f"bad magic in {path_prefix}.idx: {magic!r}")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"unsupported version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            (seq_count,) = struct.unpack("<Q", f.read(8))
            (doc_count,) = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx = np.memmap(path_prefix + ".idx", mode="r", dtype=np.uint8)
        pos = offset
        self.sizes = idx[pos:pos + 4 * seq_count].view(np.int32)
        pos += 4 * seq_count
        self.pointers = idx[pos:pos + 8 * seq_count].view(np.int64)
        pos += 8 * seq_count
        self.doc_idx = idx[pos:pos + 8 * doc_count].view(np.int64)
        self.data = np.memmap(path_prefix + ".bin", mode="r", dtype=self.dtype)

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start = self.pointers[i] // self.dtype.itemsize
        return self.data[start:start + self.sizes[i]]

    def token_view(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(token_data, document_lengths, document_start_indices) — the
        triple the packer consumes. Assumes sequences are contiguous in .bin
        (true for Megatron-built files)."""
        starts = self.pointers // self.dtype.itemsize
        return self.data, self.sizes.astype(np.int64), starts.astype(np.int64)


def write_mmap_dataset(path_prefix: str, documents, dtype=np.uint16):
    """Write documents (list of 1-D int arrays) in the indexed format.

    Used by tests and the offline re-tokenization tool; round-trips with
    MMapIndexedDataset and with the reference's reader.
    """
    dtype = np.dtype(dtype)
    sizes, pointers = [], []
    offset = 0
    with open(path_prefix + ".bin", "wb") as f:
        for doc in documents:
            arr = np.asarray(doc, dtype=dtype)
            f.write(arr.tobytes(order="C"))
            sizes.append(len(arr))
            pointers.append(offset)
            offset += arr.nbytes
    doc_idx = np.arange(len(sizes) + 1, dtype=np.int64)  # one sequence per doc
    with open(path_prefix + ".idx", "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<B", _DTYPE_CODES[dtype]))
        f.write(struct.pack("<Q", len(sizes)))
        f.write(struct.pack("<Q", len(doc_idx)))
        f.write(np.asarray(sizes, np.int32).tobytes())
        f.write(np.asarray(pointers, np.int64).tobytes())
        f.write(doc_idx.tobytes())
