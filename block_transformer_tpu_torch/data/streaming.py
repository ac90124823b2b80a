"""Streaming raw-text packer (deprecated-route parity; port of
``block_transformer_tpu/data/streaming.py``).

Counterpart of the reference's ``LanguageModelingDataset``
(custom_dataset/language_modeling_dataset.py:14-144, deprecated there as
of March 2024 in favor of the pre-tokenized ``TokenizedCorpusDataset``):
an infinite/finite iterator over raw-text documents that batch-tokenizes
through a character buffer and packs fixed-``max_length`` samples. The
host side is plain numpy generators (the device never sees ragged text);
the trainer consumes the same ``{input_ids, attention_mask}`` dict the
mmap packer produces, so the two routes are interchangeable.

Semantics mirrored from the reference:
  - per document: optional random first-block left padding (0 ..
    block_length-1 pad ids, seeded), content, one EOS, right padding to
    a block boundary (``pad_to_block_boundary``);
  - a character-count buffer batches tokenizer calls (``buffer_size``);
  - packed samples may straddle documents (and epochs when
    ``continuous``);
  - global shuffle per epoch (seed + epoch), local shuffle within each
    emitted batch of full samples;
  - block mode: attention_mask = 0 exactly on pad ids; vanilla mode
    (block_length=None): all-ones.

Differences (deliberate, same observable behavior): padding is inserted
as token *ids* after tokenization rather than pad *strings* before it —
identical output for any tokenizer whose pad token maps to one id, and
it avoids tokenizers merging pad strings with content.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np


class StreamingTextDataset:
    """Iterable of packed samples from raw text.

    ``texts``: a sequence of strings, or of dicts with ``text_field``.
    ``tokenizer``: HF-style (callable on list[str] returning
    {"input_ids": list[list[int]]}, with ``eos_token_id`` /
    ``pad_token_id``) or any object with an ``encode(str) -> list[int]``
    method plus those two ids.
    ``block_length=None`` is vanilla mode (no padding, all-ones mask).
    """

    def __init__(self, texts, tokenizer, block_length: Optional[int],
                 max_length: int, text_field: Optional[str] = None,
                 data_formatter: Optional[Callable] = None,
                 continuous: bool = True, buffer_size: int = 2 ** 22,
                 seed: int = 42, global_shuffling: bool = True,
                 local_shuffling: bool = True,
                 random_pad_first_block: bool = True,
                 pad_to_block_boundary: bool = True,
                 transforms: Optional[list] = None):
        self.texts = texts
        self.tokenizer = tokenizer
        self.block_length = block_length
        self.max_length = max_length
        self.text_field = text_field
        self.data_formatter = data_formatter
        self.continuous = continuous
        self.buffer_size = buffer_size
        self.seed = seed
        self.global_shuffling = global_shuffling
        self.local_shuffling = local_shuffling
        self.random_pad_first_block = random_pad_first_block
        self.pad_to_block_boundary = pad_to_block_boundary
        self.transforms = transforms or []

        self.block_mode = block_length is not None
        self.eos_id = tokenizer.eos_token_id
        if self.eos_id is None:
            raise ValueError("tokenizer must define eos_token_id")
        self.pad_id = getattr(tokenizer, "pad_token_id", None)
        if self.block_mode:
            if self.pad_id is None:
                raise ValueError("block mode requires a pad_token_id")
            if max_length % block_length != 0:
                raise ValueError(
                    f"max_length ({max_length}) must be divisible by "
                    f"block_length ({block_length})")

    def __len__(self) -> int:
        # like the reference: the document count, NOT the packed count
        return len(self.texts)

    # ------------------------------------------------------------------
    def _text_of(self, item) -> str:
        if self.data_formatter is not None:
            return self.data_formatter(item)
        if self.text_field is not None:
            return item[self.text_field]
        if isinstance(item, str):
            return item
        raise ValueError("specify text_field or data_formatter for "
                         "non-string items")

    def _tokenize_batch(self, docs: List[str]) -> List[List[int]]:
        if callable(self.tokenizer):
            try:
                out = self.tokenizer(docs, add_special_tokens=False)
                return [list(x) for x in out["input_ids"]]
            except TypeError:
                pass
        return [list(self.tokenizer.encode(d)) for d in docs]

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)         # doc-level padding
        local_rng = np.random.default_rng(self.seed)   # sample shuffles
        epoch = 0
        order = self._epoch_order(0)
        pos = 0
        buffer: List[str] = []
        pad_lens: List[int] = []
        buffered_chars = 0
        token_buffer: List[int] = []
        running = True
        L = self.block_length

        while running:
            # fill the character buffer
            while buffered_chars < self.buffer_size:
                if pos >= len(order):
                    if self.continuous:
                        epoch += 1
                        order = self._epoch_order(epoch)
                        pos = 0
                    else:
                        running = False
                        break
                doc = self._text_of(self.texts[int(order[pos])])
                pos += 1
                buffer.append(doc)
                pad_lens.append(
                    int(rng.integers(0, L))
                    if self.block_mode and self.random_pad_first_block
                    else 0)
                buffered_chars += len(doc)

            if buffer:
                tokenized = self._tokenize_batch(buffer)
                for toks, pre in zip(tokenized, pad_lens):
                    toks = [self.pad_id] * pre + toks + [self.eos_id] \
                        if self.block_mode else toks + [self.eos_id]
                    if self.block_mode and self.pad_to_block_boundary:
                        toks.extend([self.pad_id] * ((-len(toks)) % L))
                    token_buffer.extend(toks)
                buffer, pad_lens, buffered_chars = [], [], 0

            n_full = len(token_buffer) // self.max_length
            if n_full == 0:
                continue
            full = np.asarray(
                token_buffer[:n_full * self.max_length],
                np.int64).reshape(n_full, self.max_length)
            token_buffer = token_buffer[n_full * self.max_length:]
            if self.local_shuffling:
                full = full[local_rng.permutation(n_full)]

            for input_ids in full:
                if self.block_mode:
                    attention_mask = (input_ids != self.pad_id).astype(np.int64)
                else:
                    attention_mask = np.ones_like(input_ids)
                sample = {"input_ids": input_ids,
                          "attention_mask": attention_mask}
                for t in self.transforms:
                    sample = t(sample)
                yield sample

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.texts)
        if self.global_shuffling:
            return np.random.default_rng(self.seed + epoch).permutation(n)
        return np.arange(n)
