"""Tokenizer registry + cross-vocabulary token mapper (port of
``block_transformer_tpu/data/tokenizer.py``).

Mirrors util/tokenizer.py (fixed registry of roberta/t5/gpt2/gpt-neo/pythia)
and util/token_mapper.py (string-keyed vocab-intersection LUTs that let a
RoBERTa/T5 embedder feed a GPT-NeoX token decoder in the ablation configs).

HF tokenizers load from the local cache only (no egress); every main config
uses pythia/pythia so ``load_tokenizer_pair`` returns ``mapper=None`` there
and nothing needs downloading at import time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

TOKENIZER_PATHS = {
    "roberta": "roberta-base",
    "t5": "t5-base",
    "gpt2": "gpt2",
    "gpt-neo": "EleutherAI/gpt-neo-125m",
    "pythia": "EleutherAI/pythia-70m",
}


class ByteTokenizer:
    """Byte-level tokenizer for local-corpus runs (build_byte_corpus.py):
    byte b -> id b + 3 (0 = eos/pad, 1/2 reserved). Implements the encode
    surface the eval adapters use; decode for generate_until."""

    eos_token_id = 0
    pad_token_id = 0
    OFFSET = 3

    def encode(self, s: str):
        return [min(ord(c), 255) + self.OFFSET for c in s]

    def decode(self, ids):
        return "".join(chr(max(0, int(t) - self.OFFSET))
                       for t in ids if t >= self.OFFSET)


def load_tokenizer(name: str):
    if name == "byte":
        return ByteTokenizer()
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(TOKENIZER_PATHS[name])


class TokenMapper:
    """Vocab-to-vocab id LUTs between an embedder tokenizer and a token
    decoder tokenizer (util/token_mapper.py:7-85 semantics).

    Mapping is by token *string*: shared strings map to each other; ids
    missing on the other side map to that side's UNK (or EOS when no UNK).
    Special tokens map pairwise by role (bos/eos/pad/unk).
    """

    def __init__(self, embedder_vocab: dict, decoder_vocab: dict,
                 embedder_specials: dict, decoder_specials: dict,
                 embedder_vocab_size: Optional[int] = None,
                 decoder_vocab_size: Optional[int] = None):
        e_size = embedder_vocab_size or (max(embedder_vocab.values()) + 1)
        d_size = decoder_vocab_size or (max(decoder_vocab.values()) + 1)

        def fallback(specials):
            for k in ("unk", "eos", "pad"):
                if specials.get(k) is not None:
                    return specials[k]
            return 0

        e_fb, d_fb = fallback(embedder_specials), fallback(decoder_specials)
        e2d = np.full(e_size, d_fb, np.int64)
        d2e = np.full(d_size, e_fb, np.int64)
        for tok, e_id in embedder_vocab.items():
            d_id = decoder_vocab.get(tok)
            if d_id is not None:
                e2d[e_id] = d_id
                d2e[d_id] = e_id
        for role in ("bos", "eos", "pad", "unk"):
            e_id = embedder_specials.get(role)
            d_id = decoder_specials.get(role)
            if e_id is not None and d_id is not None:
                e2d[e_id] = d_id
                d2e[d_id] = e_id
        self._e2d = e2d
        self._d2e = d2e

    @staticmethod
    def from_tokenizers(embedder_tok, decoder_tok,
                        embedder_vocab_size=None, decoder_vocab_size=None
                        ) -> "TokenMapper":
        def specials(t):
            return {"bos": t.bos_token_id, "eos": t.eos_token_id,
                    "pad": t.pad_token_id, "unk": t.unk_token_id}
        return TokenMapper(embedder_tok.get_vocab(), decoder_tok.get_vocab(),
                           specials(embedder_tok), specials(decoder_tok),
                           embedder_vocab_size, decoder_vocab_size)

    def embedder_to_token_decoder(self, ids):
        return self._e2d[np.asarray(ids)]

    def token_decoder_to_embedder(self, ids):
        return self._d2e[np.asarray(ids)]


def load_tokenizer_pair(embedder_name: str, decoder_name: str
                        ) -> Tuple[object, Optional[TokenMapper]]:
    """(decoder tokenizer, mapper-or-None) per util/tokenizer.py:18-31."""
    dec = load_tokenizer(decoder_name)
    if embedder_name == decoder_name:
        return dec, None
    emb = load_tokenizer(embedder_name)
    return dec, TokenMapper.from_tokenizers(emb, dec)
