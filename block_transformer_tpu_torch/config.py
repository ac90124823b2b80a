"""Configuration for the PyTorch port: a copy of ``block_transformer_tpu/config.py``.

The port imports nothing of the JAX package, so it carries its own copy of
the dataclasses, ``make_block_config``, ``get_config`` with the main model
family ``_BLOCK_MAIN``, and ``get_vanilla_config`` with the vanilla GPT-NeoX
baselines ``_VANILLA``. ``tests/test_torch_bridge.py`` and
``tests/test_torch_vanilla.py`` hold the copy to the original field for
field.

The dataclasses mirror the upstream Block Transformer's Hydra YAML schema
(``conf/trainer/*.yaml`` and ``util/config.py``): the autofill heuristics
(head-dim by hidden size,
``intermediate_size = 4*hidden``, embedder hidden derived from the block
decoder hidden under concat projection) reproduce
``util/config.py:86-105`` and ``model/embedder/lookup.py:44-53`` so that a
config named ``block_main_b4_5`` here describes numerically the same model as
the reference config of the same name.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


def _head_dim_for_hidden(hidden_size: int) -> int:
    # Reference heuristic: util/config.py:92-98
    if hidden_size <= 256:
        return 32
    elif hidden_size <= 1536:
        return 64
    else:
        return 128


@dataclass(frozen=True)
class NeoXConfig:
    """GPT-NeoX (Pythia-style) stack hyperparameters.

    Defaults follow EleutherAI/pythia-*-deduped conventions, which the
    reference inherits via ``AutoConfig.from_pretrained("EleutherAI/pythia-410m-deduped")``
    (model/utils.py:131-201): rotary_pct 0.25, parallel residual, exact GeLU,
    layer-norm eps 1e-5, untied LM head, vocab 50304, bos=eos=pad=0.
    """

    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    initializer_range: float = 0.02
    attention_bias: bool = True
    bos_token_id: int = 0
    eos_token_id: int = 0
    pad_token_id: int = 0
    # Attention backend: "xla" (lax einsum softmax, always available) or
    # "pallas" (fused flash-style kernel, TPU only). The TPU analogue of the
    # reference's attn_implementation switch (conf/trainer/*.yaml).
    attn_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @staticmethod
    def from_hidden_layers(hidden_size: int, num_layers: int,
                           vocab_size: int = 50304,
                           max_position_embeddings: int = 2048,
                           num_heads: Optional[int] = None,
                           intermediate_size: Optional[int] = None,
                           **kw) -> "NeoXConfig":
        """Build a config the way the reference autofills one (util/config.py:86-105)."""
        if num_heads is None:
            hd = _head_dim_for_hidden(hidden_size)
            if hidden_size % hd != 0:
                raise ValueError(f"hidden_size {hidden_size} not divisible by head dim {hd}")
            num_heads = hidden_size // hd
        if intermediate_size is None:
            intermediate_size = hidden_size * 4
        return NeoXConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                          num_layers=num_layers, num_heads=num_heads,
                          intermediate_size=intermediate_size,
                          max_position_embeddings=max_position_embeddings, **kw)


@dataclass(frozen=True)
class EmbedderConfig:
    """Lookup embedder (model/embedder/lookup.py) configuration.

    ``projection_method`` in {"concat", "projection_layer"}; under concat the
    embedder hidden size must equal ``projection_hidden_size // (block_length
    // n_embedding_tokens)`` (model/embedder/lookup.py:44-53).
    """

    cls: str = "lookup"   # lookup | roberta | roberta_cls | t5
    vocab_size: int = 50304
    hidden_size: int = 512
    n_embedding_tokens: int = 1
    projection_method: str = "concat"
    projection_hidden_size: int = 2048  # == block decoder hidden size
    initializer_range: float = 0.02
    pad_token_id: int = 0
    # encoder-embedder (roberta/roberta_cls/t5) stack shape; hidden_size is
    # the encoder width (model/embedder/{roberta,t5}.py ablations)
    encoder_layers: int = 2
    encoder_heads: Optional[int] = None
    n_cls_tokens: int = 0   # roberta_cls only

    def __post_init__(self):
        if self.cls not in ("lookup", "roberta", "roberta_cls", "t5"):
            raise NotImplementedError(f"embedder cls {self.cls!r}")
        if self.projection_method not in ("concat", "projection_layer"):
            raise ValueError(f"bad projection_method {self.projection_method!r}")


@dataclass(frozen=True)
class TokenDecoderConfig:
    neox: NeoXConfig = field(default_factory=NeoXConfig)
    decoding_strategy: str = "prefix"   # prefix | summation | cross_attention
    expansion_method: Optional[str] = "expansion_layer"  # expansion_layer | None
    expansion_ratio: Optional[int] = 2
    cls: str = "gpt-neo-x"              # gpt-neo-x | t5

    def __post_init__(self):
        if self.decoding_strategy not in ("prefix", "summation",
                                          "cross_attention"):
            raise NotImplementedError(
                f"decoding_strategy {self.decoding_strategy!r} not implemented")
        if self.decoding_strategy == "cross_attention" and self.cls != "t5":
            # util/config.py:107-109: cross_attention only for T5TokenDecoder
            raise ValueError("cross_attention requires token_decoder cls 't5'")


@dataclass(frozen=True)
class BlockTransformerConfig:
    """Full hierarchical model configuration.

    Semantics mirror model/block_transformer.py:14-48 plus the reference YAML
    schema. ``n_expanded_emb = n_embedding_tokens * expansion_ratio`` is the
    token-decoder prefix length under the prefix strategy
    (model/token_decoder/base.py:47).
    """

    block_length: int = 4
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    block_decoder: NeoXConfig = field(default_factory=NeoXConfig)
    token_decoder: TokenDecoderConfig = field(default_factory=TokenDecoderConfig)
    # block decoder family: "gpt-neo-x" (main) or "gpt-neo" (ablation;
    # alternating global/local band attention, learned positions)
    block_decoder_cls: str = "gpt-neo-x"
    block_decoder_window: int = 256   # gpt-neo local window (block units)
    use_token_decoding_loss: bool = True
    use_block_decoding_loss: bool = False
    block_decoding_loss_weight: float = 1.0
    block_decoding_loss_type: str = "contrastive"
    use_auto_encoding_loss: bool = False
    auto_encoding_loss_weight: float = 1.0
    name: str = "block"

    def __post_init__(self):
        e = self.embedder
        if e.projection_method == "concat":
            # concat source length: block tokens, or CLS tokens for the
            # roberta_cls embedder (model/embedder/roberta_cls.py:80-93)
            src = (e.n_cls_tokens if e.cls == "roberta_cls"
                   else self.block_length)
            per = src // e.n_embedding_tokens
            if e.hidden_size * per != e.projection_hidden_size:
                raise ValueError(
                    "concat projection requires embedder.hidden_size * "
                    f"({src} // n_embedding_tokens) == projection_hidden_size; "
                    f"got {e.hidden_size} * {per} != {e.projection_hidden_size}")
        if e.projection_hidden_size != self.block_decoder.hidden_size:
            raise ValueError("projection_hidden_size must equal block decoder hidden size")

    @property
    def n_embedding_tokens(self) -> int:
        return self.embedder.n_embedding_tokens

    @property
    def expansion_ratio(self) -> int:
        r = self.token_decoder.expansion_ratio
        if r is None:
            # Reference default: summation/cross_attention use block_length
            # (model/token_decoder/base.py:34-46)
            return self.block_length
        return r

    @property
    def n_expanded_emb(self) -> int:
        return self.n_embedding_tokens * self.expansion_ratio

    @property
    def vocab_size(self) -> int:
        return self.token_decoder.neox.vocab_size

    @property
    def eos_token_id(self) -> int:
        return self.token_decoder.neox.eos_token_id

    @property
    def pad_token_id(self) -> int:
        return self.token_decoder.neox.pad_token_id

    @property
    def bos_token_id(self) -> int:
        # BaseTokenDecoder.__init__: bos := eos when undefined
        # (model/token_decoder/base.py:53-54)
        return self.token_decoder.neox.bos_token_id

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "BlockTransformerConfig":
        d = dict(d)
        d["embedder"] = EmbedderConfig(**d["embedder"])
        d["block_decoder"] = NeoXConfig(**d["block_decoder"])
        td = dict(d["token_decoder"])
        td["neox"] = NeoXConfig(**td["neox"])
        d["token_decoder"] = TokenDecoderConfig(**td)
        return BlockTransformerConfig(**d)

    @staticmethod
    def from_json(s: str) -> "BlockTransformerConfig":
        return BlockTransformerConfig.from_dict(json.loads(s))


def make_block_config(name: str,
                      block_decoder_hidden: int,
                      block_decoder_layers: int,
                      token_decoder_hidden: Optional[int] = None,
                      token_decoder_layers: Optional[int] = None,
                      block_length: int = 4,
                      n_embedding_tokens: int = 1,
                      expansion_ratio: int = 2,
                      decoding_strategy: str = "prefix",
                      vocab_size: int = 50304,
                      max_length: int = 2048,
                      **kw) -> BlockTransformerConfig:
    """Build a main-family config (lookup embedder + concat + prefix decoding).

    Matches the shape rules of e.g. conf/trainer/block_main_b4_1.2b.yaml:
    embedder hidden = block_decoder_hidden // (block_length // n_embedding_tokens);
    block decoder positions are measured in embedding tokens
    (max_length // block_length * n_embedding_tokens fits within 2048).
    """
    token_decoder_hidden = token_decoder_hidden or block_decoder_hidden
    token_decoder_layers = token_decoder_layers or block_decoder_layers
    per = block_length // n_embedding_tokens
    assert block_decoder_hidden % per == 0
    emb = EmbedderConfig(vocab_size=vocab_size,
                         hidden_size=block_decoder_hidden // per,
                         n_embedding_tokens=n_embedding_tokens,
                         projection_method="concat",
                         projection_hidden_size=block_decoder_hidden)
    blk = NeoXConfig.from_hidden_layers(block_decoder_hidden, block_decoder_layers,
                                        vocab_size=vocab_size,
                                        max_position_embeddings=max_length)
    # Token decoder sees at most n_expanded_emb + block_length positions.
    tok_neox = NeoXConfig.from_hidden_layers(
        token_decoder_hidden, token_decoder_layers, vocab_size=vocab_size,
        max_position_embeddings=max_length)
    tok = TokenDecoderConfig(neox=tok_neox, decoding_strategy=decoding_strategy,
                             expansion_method="expansion_layer",
                             expansion_ratio=expansion_ratio)
    return BlockTransformerConfig(block_length=block_length, embedder=emb,
                                  block_decoder=blk, token_decoder=tok,
                                  name=name, **kw)


# ---------------------------------------------------------------------------
# Named model family — numerically mirrors conf/trainer/*.yaml of the reference
# ---------------------------------------------------------------------------

_BLOCK_MAIN = {
    # name -> (hidden, layers)   [block decoder == token decoder shape;
    # from conf/trainer/block_main_b4_*.yaml]
    "block_main_b4_5": (256, 3),
    "block_main_b4_19": (512, 3),
    "block_main_b4_85": (768, 6),
    "block_main_b4_300": (1024, 12),
    "block_main_b4_800": (2048, 8),
    "block_main_b4_1.2b": (2048, 12),
}


_VANILLA = {
    # name -> (hidden, layers, heads) for the vanilla GPTNeoX baselines.
    # vanilla_31 overrides hidden/layers/heads on a pythia-410m base, with
    # num_attention_heads set explicitly to 8 (conf/trainer/vanilla_31.yaml,
    # applied via setattr in model/utils.py:73-81); the rest are stock
    # pythia-{70,160,410}m-deduped shapes.
    "vanilla_31": (256, 6, 8),
    "vanilla_70": (512, 6, 8),
    "vanilla_160": (768, 12, 12),
    "vanilla_410": (1024, 24, 16),
}


def get_config(name: str, **overrides) -> BlockTransformerConfig:
    if name in _BLOCK_MAIN:
        h, l = _BLOCK_MAIN[name]
        return make_block_config(name, h, l, **overrides)
    raise KeyError(f"unknown config {name!r}; known: {sorted(_BLOCK_MAIN)}")


def get_vanilla_config(name: str, **overrides) -> NeoXConfig:
    if name in _VANILLA:
        h, l, heads = _VANILLA[name]
        overrides.setdefault("num_heads", heads)
        return NeoXConfig.from_hidden_layers(h, l, **overrides)
    raise KeyError(f"unknown vanilla config {name!r}; known: {sorted(_VANILLA)}")
