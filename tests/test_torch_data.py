"""The port's data layer (``data/``) against the JAX package's, on the CPU:
the same seeded numpy inputs through both sides, every comparison exact.

- ``PackedDataset``: samples, batches and the padded layout in block and
  vanilla mode, with and without the random first-block pad and the pad to
  the block boundary; the native packer (``csrc/packer.cpp`` built into
  ``build/torch_packer/``) equals the numpy mapping, and ``last_route``
  says which ran.
- ``block_split``: the sampled lengths of every distribution, the
  variable-length split and ``fetch_train_batch`` against JAX's
  ``make_train_batch`` (fixed and variable).
- ``mmap_dataset``: a corpus written by each side gives the same bytes and
  reads back equal through either reader.
- ``tokenizer``, ``streaming``, ``retokenized_corpus`` and ``dispatch``'s
  local-file routes with ``ByteTokenizer``.
"""

import os
import shutil

import numpy as np
import pytest

from block_transformer_tpu.data import block_split as jax_bs
from block_transformer_tpu.data import dispatch as jax_dispatch
from block_transformer_tpu.data import mmap_dataset as jax_mmap
from block_transformer_tpu.data import packing as jax_packing
from block_transformer_tpu.data import retokenized_corpus as jax_retok
from block_transformer_tpu.data import streaming as jax_streaming
from block_transformer_tpu.data import tokenizer as jax_tok
from block_transformer_tpu_torch.data import block_split as bs
from block_transformer_tpu_torch.data import dispatch
from block_transformer_tpu_torch.data import mmap_dataset
from block_transformer_tpu_torch.data import native
from block_transformer_tpu_torch.data import packing
from block_transformer_tpu_torch.data import retokenized_corpus as retok
from block_transformer_tpu_torch.data import streaming
from block_transformer_tpu_torch.data import tokenizer as tok


def corpus_docs(seed=0, n=40, vocab=300):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(3, 60)) for _ in range(n)]


def make_corpus(module, docs, dtype=np.uint16):
    lengths = np.array([len(d) for d in docs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return module.TokenizedCorpus(np.concatenate(docs).astype(dtype),
                                  lengths, starts)


MODES = {"block": dict(block_length=4, pad_token=1),
         "block no random pad": dict(block_length=4, pad_token=1,
                                     random_pad_first_block=False),
         "block no boundary pad": dict(block_length=4, pad_token=1,
                                       pad_to_block_boundary=False),
         "vanilla": dict(block_length=None)}


def pair(mode, dtype=np.uint16, max_length=32, seed=3, **over):
    docs = corpus_docs()
    kw = dict(eos_token=0, seed=seed, **{**MODES[mode], **over})
    return (jax_packing.PackedDataset(make_corpus(jax_packing, docs, dtype),
                                      max_length, **kw),
            packing.PackedDataset(make_corpus(packing, docs, dtype),
                                  max_length, **kw))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_dataset_equals_jax(mode):
    want, got = pair(mode)
    assert len(got) == len(want) > 8
    for name in ("left_pad", "right_pad", "padded_doc_lengths",
                 "padded_doc_starts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for i in (0, 1, len(want) - 1, len(want) + 2):
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(got[i][k], want[i][k])


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_native_packer_equals_numpy_and_jax(mode, dtype):
    want, got = pair(mode, dtype)
    idxs = np.array([0, 3, 5, len(got) - 1, len(got) + 4])
    numpy_batch = got.get_batch(idxs, use_native=False)
    assert got.last_route == "numpy"
    native_batch = got.get_batch(idxs)
    assert got.last_route == ("native" if native.get_packer() else "numpy")
    jax_batch = want.get_batch(idxs, use_native=False)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(native_batch[k], numpy_batch[k])
        np.testing.assert_array_equal(numpy_batch[k], jax_batch[k])
        assert native_batch[k].dtype == numpy_batch[k].dtype == np.int64


def test_native_packer_builds_here():
    """g++ is on this machine's path: the native route must be taken."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    assert native.get_packer() is not None
    _, got = pair("block")
    got.get_batch(np.arange(2))
    assert got.last_route == "native"


def test_packed_dataset_rejects_what_jax_rejects():
    docs = make_corpus(packing, corpus_docs())
    with pytest.raises(ValueError):
        packing.PackedDataset(docs, 30, eos_token=0, pad_token=1,
                              block_length=4)
    with pytest.raises(ValueError):
        packing.PackedDataset(docs, 32, eos_token=0, block_length=4)


DISTRIBUTIONS = [("uniform", dict(mean=4, radius=3)),
                 ("uniform", dict(mean=4, radius=1)),
                 ("uniform", dict(mean=3)),
                 ("fixed", dict(length=4))]


@pytest.mark.parametrize("name,kw", DISTRIBUTIONS,
                         ids=lambda x: str(x))
def test_block_lengths_equal_jax(name, kw):
    got = bs.DISTRIBUTIONS[name](**kw, seed=7)
    want = jax_bs.DISTRIBUTIONS[name](**kw, seed=7)
    assert (got.mean, got.max, got.domain) == (want.mean, want.max,
                                               want.domain)
    for index in (None, 0, 1, 17, 2 ** 33):
        a = got.get_lengths(48, index)
        np.testing.assert_array_equal(a, want.get_lengths(48, index))
        assert a.sum() == 48 and a.dtype == np.int64


def test_custom_pmf_lengths_equal_jax():
    pmf = np.array([0, 1, 3, 0, 2, 1.5])
    got, want = bs.BlockLengthDistribution(pmf, 5), \
        jax_bs.BlockLengthDistribution(pmf, 5)
    for index in range(6):
        np.testing.assert_array_equal(got.get_lengths(64, index),
                                      want.get_lengths(64, index))
    with pytest.raises(ValueError):
        bs.BlockLengthDistribution(np.array([1.0, 1.0]))


def test_split_blocks_variable_equals_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(2, 90, 40)
    att = np.ones_like(ids)
    att[:5] = 0
    sample = {"input_ids": ids, "attention_mask": att,
              "labels": np.where(att == 0, -100, ids), "index": 9}
    dist_kw = dict(mean=4, radius=3, seed=2)
    got = bs.split_blocks_variable(sample, bs.UniformDistribution(**dist_kw),
                                   1)
    want = jax_bs.split_blocks_variable(
        sample, jax_bs.UniformDistribution(**dist_kw), 1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("dist", [None, "fixed", "uniform"])
def test_fetch_train_batch_equals_jax_make_train_batch(dist):
    L = 7 if dist == "uniform" else 4      # blocks pad to the max, 7
    want_ds, got_ds = pair("block", max_length=8 * L, block_length=L)
    mk = {None: lambda m: None,
          "fixed": lambda m: m.FixedDistribution(length=4, seed=1),
          "uniform": lambda m: m.UniformDistribution(mean=4, radius=3,
                                                     seed=1)}[dist]
    idxs = np.array([2, 0, 11, 5])
    got = packing.fetch_train_batch(got_ds, idxs, L, distribution=mk(bs))
    want = jax_packing.make_train_batch(want_ds, idxs, L,
                                        distribution=mk(jax_bs))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype == np.int32


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_mmap_dataset_equals_jax(tmp_path, dtype):
    docs = corpus_docs(seed=5, n=12)
    mmap_dataset.write_mmap_dataset(str(tmp_path / "port"), docs, dtype)
    jax_mmap.write_mmap_dataset(str(tmp_path / "jax"), docs, dtype)
    for ext in (".bin", ".idx"):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes())
    got = mmap_dataset.MMapIndexedDataset(str(tmp_path / "jax"))
    want = jax_mmap.MMapIndexedDataset(str(tmp_path / "port"))
    assert len(got) == len(want) == 12 and got.dtype == want.dtype
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], docs[i].astype(dtype))
    for a, b in zip(got.token_view(), want.token_view()):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.idx").write_bytes(b"NOTMAGIC0" + b"\0" * 32)
    with pytest.raises(ValueError):
        mmap_dataset.MMapIndexedDataset(str(tmp_path / "bad"))


def test_byte_tokenizer_and_token_mapper_equal_jax():
    text = "Block Transformer\né€"
    assert tok.ByteTokenizer().encode(text) == jax_tok.ByteTokenizer().encode(
        text)
    ids = tok.ByteTokenizer().encode(text)
    assert tok.ByteTokenizer().decode(ids) == jax_tok.ByteTokenizer().decode(
        ids)
    assert isinstance(tok.load_tokenizer("byte"), tok.ByteTokenizer)
    ev = {"a": 0, "b": 1, "c": 2, "<unk>": 3, "</s>": 4}
    dv = {"b": 5, "c": 0, "d": 1, "<|endoftext|>": 2}
    args = (ev, dv, {"unk": 3, "eos": 4}, {"eos": 2, "unk": None}, 6, 7)
    got, want = tok.TokenMapper(*args), jax_tok.TokenMapper(*args)
    for e in (np.arange(6), np.array([[4, 0], [1, 2]])):
        np.testing.assert_array_equal(got.embedder_to_token_decoder(e),
                                      want.embedder_to_token_decoder(e))
    np.testing.assert_array_equal(got.token_decoder_to_embedder(np.arange(7)),
                                  want.token_decoder_to_embedder(np.arange(7)))


TEXTS = ["the quick brown fox", "jumps over", "the lazy dog " * 5, "",
         "block transformers decode blocks", "x" * 37]


@pytest.mark.parametrize("block_length", [4, None])
@pytest.mark.parametrize("continuous", [True, False])
def test_streaming_equals_jax(block_length, continuous):
    kw = dict(block_length=block_length, max_length=16, buffer_size=40,
              seed=3, continuous=continuous)
    got = streaming.StreamingTextDataset(TEXTS, tok.ByteTokenizer(), **kw)
    want = jax_streaming.StreamingTextDataset(TEXTS, jax_tok.ByteTokenizer(),
                                              **kw)
    n = 0
    for a, b in zip(got, want):
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        n += 1
        if n == 30:
            break
    assert n >= 8
    if not continuous:
        assert len(list(got)) == len(list(want))


def test_retokenized_corpus_and_dispatch_equal_jax(tmp_path):
    docs = [np.array(tok.ByteTokenizer().encode(t), np.int64)
            for t in TEXTS if t]
    src = make_corpus(packing, docs, np.int64)
    jsrc = make_corpus(jax_packing, docs, np.int64)
    retok.convert_corpus(src, tok.ByteTokenizer(), tok.ByteTokenizer(),
                         str(tmp_path / "port"), shard_docs=2)
    jax_retok.convert_corpus(jsrc, jax_tok.ByteTokenizer(),
                             jax_tok.ByteTokenizer(), str(tmp_path / "jax"),
                             shard_docs=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    mmap_dataset.write_mmap_dataset(str(tmp_path / "idx"), docs)

    def same(a, b):
        for f in ("token_data", "document_lengths", "document_indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))

    for route in (str(tmp_path / "port"), str(tmp_path / "idx")):
        same(dispatch.load_corpus(route), jax_dispatch.load_corpus(route))
    same(dispatch.load_corpus("pythia_pile", path=str(tmp_path / "idx")),
         jax_dispatch.load_corpus("pythia_pile", path=str(tmp_path / "idx")))
    y = {"dataset": "t5_pile", "t5_pile_shards_path": str(tmp_path / "port")}
    same(dispatch.load_corpus_from_yaml(y),
         jax_dispatch.load_corpus_from_yaml(y))
    with pytest.raises(ValueError):
        dispatch.load_corpus(str(tmp_path / "missing"))
    with pytest.raises(ValueError):
        dispatch.load_corpus("pythia_pile")
