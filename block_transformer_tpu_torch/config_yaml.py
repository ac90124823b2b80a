"""Reference-YAML compatibility: ``configs/*.yaml`` into the port's dataclass
configs (port of ``block_transformer_tpu/config_yaml.py``).

The loaders apply the reference schema's autofill rules as the JAX package
does: the head-dim heuristic and ``intermediate = 4h`` of
``util/config.py:86-105`` (through ``NeoXConfig.from_hidden_layers``) and
the lookup embedder's hidden size derived from the block decoder's
(``model/embedder/lookup.py:44-53``). The training keys map onto
``train.trainer.TrainerConfig``.

A machine with the card need not have PyYAML, so the files are read by
``safe_load`` here: a reader of the subset of YAML the shipped configs use
(block and flow mappings, comments, plain and quoted scalars) that gives
what PyYAML's ``yaml.safe_load`` gives on them. Scalars resolve by
PyYAML's YAML 1.1 rules: ``null``/``~``/empty, the 1.1 booleans
(``true``/``yes``/``on`` and their opposites), ints, and floats only with
a dot and a signed exponent, so ``6e-4`` stays the string ``'6e-4'`` and
``load_trainer_kwargs_yaml`` takes ``float()`` of it, as the JAX loader
does. Sequences, anchors, aliases, tags, block scalars and document
markers are outside the subset and raise ``YAMLSubsetError``.
"""

from __future__ import annotations

import re

from block_transformer_tpu_torch.config import (BlockTransformerConfig,
                                                EmbedderConfig, NeoXConfig,
                                                TokenDecoderConfig)


class YAMLSubsetError(ValueError):
    """A construct outside the YAML subset ``safe_load`` reads."""


# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_SPECIAL = "[]&*!|>%@`-?"   # a plain scalar may not start with these


def _resolve(text: str, where: str):
    """A plain scalar -> None, bool, int, float or str, as PyYAML resolves
    and constructs it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if ":" in text and (_INT.match(text) or _FLOAT.match(text)):
        raise YAMLSubsetError(f"{where}: sexagesimal number {text!r}")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    # '-' and '?' start a plain scalar only when a non-blank follows
    if text[0] in _SPECIAL and not (text[0] in "-?" and len(text) > 1
                                    and text[1] not in " \t"):
        raise YAMLSubsetError(f"{where}: {text!r} is outside the subset "
                              "(sequences, anchors, aliases, tags, block "
                              "scalars and directives are not read)")
    return text


def _quoted(s: str, i: int, where: str):
    """The quoted scalar starting at s[i]: (value, index after it)."""
    q = s[i]
    out, i = [], i + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = s[i + 1:i + 2]
            table = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
                     "0": "\0", " ": " "}
            if esc not in table:
                raise YAMLSubsetError(f"{where}: escape \\{esc} is outside "
                                      "the subset")
            out.append(table[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise YAMLSubsetError(f"{where}: unterminated quoted scalar")


def _strip_comment(line: str) -> str:
    """The line without its comment ('#' at the start or after a blank,
    outside quotes), right-stripped."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t:{,"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow_mapping(s: str, i: int, where: str):
    """The flow mapping starting at s[i] == '{': (dict, index after it)."""
    out = {}
    i += 1

    def skip(i):
        while i < len(s) and s[i] in " \t":
            i += 1
        return i

    def scalar(i, stops):
        i = skip(i)
        if i < len(s) and s[i] in "'\"":
            v, i = _quoted(s, i, where)
            return v, skip(i)
        if i < len(s) and s[i] == "{":
            v, i = _flow_mapping(s, i, where)
            return v, skip(i)
        if i < len(s) and s[i] == "[":
            raise YAMLSubsetError(f"{where}: flow sequences are outside the "
                                  "subset")
        j = i
        while j < len(s) and not (s[j] in stops or (
                s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,}"))):
            j += 1
        return _resolve(s[i:j].strip(), where), j

    i = skip(i)
    if i < len(s) and s[i] == "}":
        return out, i + 1
    while True:
        key, i = scalar(i, ",}")
        if i < len(s) and s[i] == ":":
            value, i = scalar(i + 1, ",}")
        else:
            value = None
        out[key] = value
        i = skip(i)
        if i >= len(s):
            raise YAMLSubsetError(f"{where}: unterminated flow mapping (a "
                                  "flow mapping must end on its line)")
        if s[i] == "}":
            return out, i + 1
        if s[i] != ",":
            raise YAMLSubsetError(f"{where}: expected ',' or '}}' in a flow "
                                  "mapping")
        i = skip(i + 1)
        if i < len(s) and s[i] == "}":
            return out, i + 1


def _value(text: str, where: str):
    """A mapping value written on its key's line."""
    if text[0] in "'\"":
        v, end = _quoted(text, 0, where)
    elif text[0] == "{":
        v, end = _flow_mapping(text, 0, where)
    elif re.search(r":(?:[ \t]|$)", text):
        raise YAMLSubsetError(f"{where}: a mapping value is not allowed "
                              "here")
    else:
        return _resolve(text, where)
    if text[end:].strip():
        raise YAMLSubsetError(f"{where}: text after a scalar or mapping")
    return v


def _split_key(content: str, where: str):
    """'key: value' -> (key, value text); the key plain or quoted."""
    if content[0] in "'\"":
        key, i = _quoted(content, 0, where)
        rest = content[i:]
        if not rest.startswith(":") or not (len(rest) == 1 or rest[1] in " \t"):
            raise YAMLSubsetError(f"{where}: expected ':' after a quoted key")
        return key, rest[1:].strip()
    if content.startswith("- ") or content == "-":
        raise YAMLSubsetError(f"{where}: block sequences are outside the "
                              "subset")
    m = re.search(r":(?:[ \t]|$)", content)
    if m is None:
        raise YAMLSubsetError(f"{where}: expected 'key: value'")
    return _resolve(content[:m.start()].rstrip(), where), \
        content[m.end():].strip()


def safe_load(text: str):
    """What ``yaml.safe_load(text)`` gives, for the subset this module
    reads: the document is a block mapping (or empty: None)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        content = _strip_comment(raw)
        if not content.strip():
            continue
        indent = len(content) - len(content.lstrip(" "))
        if content[indent] == "\t":
            raise YAMLSubsetError(f"{where}: tab indentation")
        if indent == 0 and (content.startswith("---")
                            or content.startswith("...")
                            or content.startswith("%")):
            raise YAMLSubsetError(f"{where}: document markers and directives "
                                  "are outside the subset")
        lines.append((indent, content.strip(), where))
    if not lines:
        return None

    def block(pos: int, indent: int):
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            _, content, where = lines[pos]
            key, rest = _split_key(content, where)
            pos += 1
            if rest:
                out[key] = _value(rest, where)
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key], pos = block(pos, lines[pos][0])
            else:
                out[key] = None
        if pos < len(lines) and lines[pos][0] > indent:
            raise YAMLSubsetError(f"{lines[pos][2]}: unexpected indentation")
        return out, pos

    doc, pos = block(0, lines[0][0])
    if pos != len(lines):
        raise YAMLSubsetError(f"{lines[pos][2]}: unexpected dedent")
    return doc


def read_yaml(path: str):
    with open(path) as f:
        return safe_load(f.read())


def _neox_from_yaml(d: dict, max_length: int, vocab_size: int) -> NeoXConfig:
    c = d.get("config", {}) or {}
    return NeoXConfig.from_hidden_layers(
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        vocab_size=c.get("vocab_size", vocab_size),
        max_position_embeddings=c.get("max_position_embeddings", max_length),
        num_heads=c.get("num_attention_heads"),
        intermediate_size=c.get("intermediate_size"),
        attn_impl="pallas" if d.get("attn_implementation") ==
        "flash_attention_2" else "xla",
    )


def load_block_config_yaml(path: str) -> BlockTransformerConfig:
    y = read_yaml(path)
    bs = y.get("block_split") or {}
    if bs.get("distribution") == "uniform":
        kw = bs.get("distribution_kwargs") or {}
        mean = kw.get("mean", 4)
        radius = kw.get("radius", mean - 1)
        # variable blocks pad to the distribution max
        block_length = mean + radius
    else:
        block_length = y.get("block_length") or \
            bs["distribution_kwargs"]["length"]
    max_length = y.get("max_length", 2048)
    e = y["embedder"]
    vocab = (e.get("config", {}) or {}).get("vocab_size", 50304)

    bd = _neox_from_yaml(y["block_decoder"], max_length, vocab)
    tdc = y["token_decoder"]
    td_cls = tdc.get("cls", "gpt-neo-x")
    if td_cls == "t5":
        # the T5 decoder's shape comes from the t5 keys (d_model/num_layers)
        tc = tdc.get("config", {}) or {}
        td_neox = NeoXConfig.from_hidden_layers(
            hidden_size=tc.get("d_model", bd.hidden_size),
            num_layers=tc.get("num_decoder_layers", tc.get("num_layers", 6)),
            vocab_size=vocab, max_position_embeddings=max_length,
            intermediate_size=tc.get("d_ff"))
    else:
        td_neox = _neox_from_yaml(tdc, max_length, vocab)
    td = TokenDecoderConfig(
        neox=td_neox,
        decoding_strategy=tdc.get("decoding_strategy", "prefix"),
        expansion_method=tdc.get("expansion_method"),
        expansion_ratio=tdc.get("expansion_ratio"),
        cls=td_cls if td_cls in ("gpt-neo-x", "t5") else "gpt-neo",
    )
    n_emb = e.get("n_embedding_tokens", 1)
    ph = bd.hidden_size
    e_cls = e.get("cls", "lookup")
    e_cfg = e.get("config", {}) or {}
    n_cls = e.get("n_cls_tokens") or 0
    # concat source length: CLS tokens for roberta_cls, block tokens else
    per = ((n_cls if e_cls == "roberta_cls" else block_length) // n_emb)
    emb = EmbedderConfig(
        cls=e_cls,
        vocab_size=vocab,
        hidden_size=e_cfg.get("hidden_size", ph // per),
        n_embedding_tokens=n_emb,
        # the reference reads a null projection_method as concat
        # (model/embedder/base.py:25-27)
        projection_method=e.get("projection_method") or "concat",
        projection_hidden_size=ph,
        encoder_layers=e_cfg.get("num_hidden_layers",
                                 e_cfg.get("num_layers", 2)),
        n_cls_tokens=n_cls,
    )
    return BlockTransformerConfig(
        block_length=block_length, embedder=emb, block_decoder=bd,
        token_decoder=td,
        block_decoder_cls=("gpt-neo" if y["block_decoder"].get("cls")
                           == "gpt-neo" else "gpt-neo-x"),
        block_decoder_window=(y["block_decoder"].get("config", {}) or {}
                              ).get("window_size", 256),
        use_token_decoding_loss=y.get("token_decoding_loss", {}).get(
            "enable", True),
        use_block_decoding_loss=y.get("block_decoding_loss", {}).get(
            "enable", False),
        block_decoding_loss_weight=y.get("block_decoding_loss", {}).get(
            "weight", 1.0),
        use_auto_encoding_loss=y.get("auto_encoding_loss", {}).get(
            "enable", False),
        auto_encoding_loss_weight=y.get("auto_encoding_loss", {}).get(
            "weight", 1.0),
        name=y.get("name", "block"),
    )


def load_vanilla_config_yaml(path: str) -> NeoXConfig:
    """A vanilla-baseline YAML (``model: gpt-neo-x`` and ``model_config``
    overrides applied over the autofill rules, as model/utils.py:58-84
    setattr's them onto the base HF config) -> NeoXConfig."""
    y = read_yaml(path)
    if y.get("model", "gpt-neo-x") != "gpt-neo-x":
        raise ValueError(f"{path}: model {y.get('model')!r} is not "
                         "gpt-neo-x")
    c = y.get("model_config", {}) or {}
    return NeoXConfig.from_hidden_layers(
        hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        vocab_size=c.get("vocab_size", 50304),
        max_position_embeddings=c.get("max_position_embeddings",
                                      y.get("max_length", 2048)),
        num_heads=c.get("num_attention_heads"),
        intermediate_size=c.get("intermediate_size"),
        attn_impl="pallas" if y.get("attn_implementation") ==
        "flash_attention_2" else "xla",
    )


def load_trainer_kwargs_yaml(path: str) -> dict:
    """The training hyperparameters of the same YAML -> TrainerConfig
    kwargs."""
    y = read_yaml(path)
    out = {
        "learning_rate": float(y.get("learning_rate", 1e-3)),
        "adam_beta1": float(y.get("adam_beta1", 0.9)),
        "adam_beta2": float(y.get("adam_beta2", 0.95)),
        "weight_decay": float(y.get("weight_decay", 0.1)),
        "num_train_steps": int(y.get("num_train_steps", 1000)),
        "stop_steps": y.get("stop_steps"),
        "num_warmup_steps": int(y.get("num_warmup_steps", 100)),
        "total_batch_size": int(y.get("total_batch_size", 8)),
        "micro_batch_size": y.get("per_device_train_batch_size"),
        "batch_size_rampup_steps": y.get("batch_size_rampup_steps"),
        "max_length": int(y.get("max_length", 2048)),
        "save_steps": int(y.get("save_steps", 1000)),
        "logging_steps": int(y.get("logging_steps", 100)),
        "param_dtype": {"bf16": "bfloat16", "fp32": "float32"}.get(
            y.get("precision", "bf16"), "bfloat16"),
    }
    bs = y.get("block_split") or {}
    if bs.get("distribution") not in (None, "fixed"):
        out["block_split_distribution"] = bs["distribution"]
        out["block_split_kwargs"] = dict(bs.get("distribution_kwargs") or {})
    if y.get("output_dir"):
        out["output_dir"] = y["output_dir"]
    elif y.get("name"):
        out["output_dir"] = f"results/{y['name']}"
    return out
