"""SentencePiece ``tokenizer.model`` directories, read without
``sentencepiece``, ``protobuf`` or ``transformers`` (none is on the card's
machine).

The JAX package hands such a directory to ``transformers.AutoTokenizer``,
which loads the slow SentencePiece tokenizer and converts it to a fast one
(``convert_slow_tokenizer``: ``LlamaConverter`` for Llama-2, Mistral and
Mixtral, ``GemmaConverter`` for Gemma). This module does the same in two
steps:

- ``read_model_proto`` decodes the protobuf wire format (varints,
  length-delimited fields, fixed32 floats) into the fields of
  ``ModelProto`` the converters read: the pieces (piece, score, type),
  ``trainer_spec`` (model_type, byte_fallback, the unk / bos / eos / pad
  ids and pieces) and ``normalizer_spec`` (add_dummy_prefix,
  remove_extra_whitespaces, escape_whitespaces); ``encode_model_proto``
  writes one.
- ``tokenizer_json`` applies the converter transformers would pick (by
  ``tokenizer_config.json``'s ``tokenizer_class``, else config.json's
  ``model_type``) under the config's ``legacy`` and ``add_prefix_space``,
  and returns what that conversion serializes to: a tokenizer.json
  document (the vocabulary and scores, the merges as ``generate_merges``
  derives them from the scores, the normalizer, pre-tokenizer and decoder,
  byte fallback, the control and user-defined pieces as added tokens),
  with the tokenizer class's default special tokens.

``HFTokenizer`` runs the result through the same BPE and Metaspace
machinery as a tokenizer.json. Unigram models (``model_type`` 1) and
tiktoken-format files (Meta's original Llama-3 ``tokenizer.model``) raise,
naming themselves: neither is taken (ROADMAP).
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass, field

from kubeai_tpu_torch.engine.tokenizer import _content, _read_json

# SentencePiece piece types (sentencepiece_model.proto).
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.model_type.
UNIGRAM, BPE = 1, 2

_REPLACEMENT = "▁"


@dataclass
class ModelProto:
    """The fields of a SentencePiece ModelProto that the converters read,
    with the proto's defaults."""

    pieces: list[tuple[str, float, int]] = field(default_factory=list)  # (piece, score, type)
    model_type: int = UNIGRAM
    vocab_size: int = 8000
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_piece: str = "<unk>"
    bos_piece: str = "<s>"
    eos_piece: str = "</s>"
    pad_piece: str = "<pad>"
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


# ---------------------------------------------------------------------------
# The protobuf wire format


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("tokenizer.model: truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7
        if shift > 63:
            raise ValueError("tokenizer.model: varint longer than 10 bytes")


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message: an int
    for varints, bytes for length-delimited fields and fixed32 / fixed64."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"tokenizer.model: unsupported wire type {wire} (field {num})")
        if i > len(buf):
            raise ValueError("tokenizer.model: truncated field")
        yield num, wire, val


def _int32(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _f32(raw: bytes) -> float:
    return struct.unpack("<f", raw)[0]


_TRAINER_INTS = {3: "model_type", 4: "vocab_size", 40: "unk_id", 41: "bos_id", 42: "eos_id",
                 43: "pad_id"}
_TRAINER_STRS = {45: "unk_piece", 46: "bos_piece", 47: "eos_piece", 48: "pad_piece"}
_NORMALIZER_BOOLS = {3: "add_dummy_prefix", 4: "remove_extra_whitespaces",
                     5: "escape_whitespaces"}


def _is_tiktoken(data: bytes) -> bool:
    """Whether *data* is a tiktoken BPE file ("<base64 token> <rank>" per
    line), the format of Meta's original Llama-3 tokenizer.model."""
    first = data.split(b"\n", 1)[0].strip()
    return re.fullmatch(rb"[A-Za-z0-9+/]+={0,2} \d+", first) is not None


def read_model_proto(data: bytes) -> ModelProto:
    """The ModelProto fields of a serialized tokenizer.model."""
    if _is_tiktoken(data):
        raise NotImplementedError(
            "tokenizer.model is a tiktoken-format BPE file (Meta's original Llama-3 "
            "tokenizer), not a SentencePiece model: not supported (ROADMAP, item 5b: "
            "tiktoken and Unigram tokenizer.model files are not taken); use the "
            "checkpoint's tokenizer.json")
    m = ModelProto()
    for num, wire, val in _fields(data):
        if num == 1 and wire == 2:
            piece, score, kind = "", 0.0, NORMAL
            for n, w, v in _fields(val):
                if n == 1 and w == 2:
                    piece = v.decode("utf-8")
                elif n == 2 and w == 5:
                    score = _f32(v)
                elif n == 3 and w == 0:
                    kind = v
            m.pieces.append((piece, score, kind))
        elif num == 2 and wire == 2:
            for n, w, v in _fields(val):
                if n in _TRAINER_INTS and w == 0:
                    setattr(m, _TRAINER_INTS[n], _int32(v))
                elif n in _TRAINER_STRS and w == 2:
                    setattr(m, _TRAINER_STRS[n], v.decode("utf-8"))
                elif n == 35 and w == 0:
                    m.byte_fallback = bool(v)
        elif num == 3 and wire == 2:
            for n, w, v in _fields(val):
                if n == 1 and w == 2:
                    m.normalizer_name = v.decode("utf-8")
                elif n == 2 and w == 2:
                    m.precompiled_charsmap = bytes(v)
                elif n in _NORMALIZER_BOOLS and w == 0:
                    setattr(m, _NORMALIZER_BOOLS[n], bool(v))
    return m


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put(out: bytearray, num: int, val) -> None:
    """One field: bool / int as a varint, float as fixed32, str / bytes
    length-delimited."""
    if isinstance(val, float):
        _put_varint(out, num << 3 | 5)
        out += struct.pack("<f", val)
    elif isinstance(val, (bool, int)):
        _put_varint(out, num << 3)
        _put_varint(out, int(val))
    else:
        raw = val.encode("utf-8") if isinstance(val, str) else val
        _put_varint(out, num << 3 | 2)
        _put_varint(out, len(raw))
        out += raw


def encode_model_proto(m: ModelProto) -> bytes:
    """*m* serialized as a tokenizer.model (every field written)."""
    out = bytearray()
    for piece, score, kind in m.pieces:
        sub = bytearray()
        _put(sub, 1, piece)
        _put(sub, 2, float(score))
        _put(sub, 3, kind)
        _put(out, 1, bytes(sub))
    trainer = bytearray()
    for n, name in sorted({**_TRAINER_INTS, **_TRAINER_STRS}.items()):
        _put(trainer, n, getattr(m, name))
    _put(trainer, 35, m.byte_fallback)
    _put(out, 2, bytes(trainer))
    norm = bytearray()
    _put(norm, 1, m.normalizer_name)
    if m.precompiled_charsmap:
        _put(norm, 2, m.precompiled_charsmap)
    for n, name in sorted(_NORMALIZER_BOOLS.items()):
        _put(norm, n, getattr(m, name))
    _put(out, 3, bytes(norm))
    return bytes(out)


# ---------------------------------------------------------------------------
# The conversion (transformers' convert_slow_tokenizer)


def generate_merges(vocab: dict, vocab_scores) -> list[tuple[str, str]]:
    """The BPE merges of a SentencePiece vocabulary, ordered by the score of
    the piece each merge makes (transformers' generate_merges)."""
    reverse = vocab_scores is not None
    vocab_scores = dict(vocab_scores) if reverse else vocab

    merges = []
    for merge, piece_score in vocab_scores.items():
        local = []
        for index in range(1, len(merge)):
            piece_l, piece_r = merge[:index], merge[index:]
            if piece_l in vocab and piece_r in vocab:
                local.append((piece_l, piece_r, piece_score))
        local = sorted(local, key=lambda x: (vocab[x[0]], vocab[x[1]]))
        merges.extend(local)

    merges = sorted(merges, key=lambda val: (val[2], len(val[0]), len(val[1])), reverse=reverse)
    return [(val[0], val[1]) for val in merges]


# The tokenizer classes whose SentencePiece model converts, and the
# model_type of config.json each family's AutoTokenizer maps to.
_CONVERTERS = {"LlamaTokenizer": "llama", "CodeLlamaTokenizer": "llama",
               "Phi3Tokenizer": "llama", "GemmaTokenizer": "gemma"}
_MODEL_TYPES = {"llama": "llama", "mistral": "llama", "mixtral": "llama", "gemma": "gemma",
                "gemma2": "gemma"}
# The tokenizer classes' default special tokens.
_DEFAULT_SPECIALS = {
    "llama": {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"},
    "gemma": {"bos_token": "<bos>", "eos_token": "<eos>", "unk_token": "<unk>",
              "pad_token": "<pad>"},
}
# GemmaConverter marks these special whatever their piece type.
_GEMMA_SPECIAL = {"<start_of_turn>", "<end_of_turn>"}


def converter_kind(path: str, cfg: dict) -> str:
    """"llama" or "gemma": the converter transformers applies to *path*'s
    tokenizer.model, by tokenizer_config.json's tokenizer_class (*cfg*),
    else by config.json's model_type."""
    cls = cfg.get("tokenizer_class")
    if cls:
        kind = _CONVERTERS.get(cls[:-4] if cls.endswith("Fast") else cls)
        if kind is None:
            raise NotImplementedError(
                f"{path}: tokenizer.model under tokenizer_class {cls!r}: only "
                f"{', '.join(sorted(_CONVERTERS))} convert")
        return kind
    model_type = _read_json(os.path.join(path, "config.json")).get("model_type")
    if model_type not in _MODEL_TYPES:
        raise NotImplementedError(
            f"{path}: tokenizer.model with no tokenizer_class and model_type {model_type!r}: "
            f"only {', '.join(sorted(_MODEL_TYPES))} map to a converter")
    return _MODEL_TYPES[model_type]


def tokenizer_json(path: str, cfg: dict) -> tuple[dict, dict]:
    """(tokenizer.json document, default special tokens) of the
    tokenizer.model in *path* under the tokenizer config *cfg*: what the
    converter transformers picks serializes to, and the tokenizer class's
    special tokens for the ones *cfg* does not name."""
    with open(os.path.join(path, "tokenizer.model"), "rb") as f:
        proto = read_model_proto(f.read())
    if proto.model_type == UNIGRAM:
        raise NotImplementedError(
            f"{path}/tokenizer.model is a SentencePiece Unigram model (model_type 1): only "
            "BPE models are read (ROADMAP, item 5b: Unigram and tiktoken tokenizer.model "
            "files are not taken)")
    if proto.model_type != BPE:
        raise NotImplementedError(
            f"{path}/tokenizer.model has SentencePiece model_type {proto.model_type}: only "
            "BPE (2) converts")
    kind = converter_kind(path, cfg)
    specials = {**_DEFAULT_SPECIALS[kind],
                **{k: _content(cfg[k]) for k in _DEFAULT_SPECIALS[kind] if cfg.get(k)}}
    legacy = cfg.get("legacy")
    legacy = True if legacy is None else legacy
    add_prefix_space = cfg.get("add_prefix_space", True)

    pieces = proto.pieces
    if kind == "llama":
        # The slow tokenizer's tokens 0..2 (its specials where they hold
        # those ids), scored 0.
        decoder = cfg.get("added_tokens_decoder") or {}
        head = [(_content(decoder[str(i)]) if str(i) in decoder else pieces[i][0], 0.0)
                for i in range(min(3, len(pieces)))]
    else:
        head = [(specials["pad_token"], 0.0), (specials["eos_token"], 0.0),
                (specials["bos_token"], 0.0)]
    vocab_scores = head + [(p, s) for p, s, _ in pieces[3:]]
    extractor_vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    if kind == "gemma":
        # Older Gemma models lack a tab piece: <0x09> becomes "\t".
        if not any(p == "\t" for p, _ in vocab_scores):
            at = next((i for i, (p, _) in enumerate(vocab_scores) if p == "<0x09>"), None)
            if at is not None:
                vocab_scores[at] = ("\t", 0.0)
        if "\t" not in extractor_vocab:
            extractor_vocab["\t"] = extractor_vocab.get("<0x09>")
    merges = generate_merges(extractor_vocab, vocab_scores)
    vocab = {p: i for i, (p, _) in enumerate(vocab_scores)}

    # Control and user-defined pieces become added tokens (control and
    # GemmaConverter's turn markers special), in id order; a piece
    # outside the vocabulary takes the next id past it.
    added, next_id = [], len(vocab)
    for i, (p, _, t) in enumerate(pieces):
        if t not in (CONTROL, USER_DEFINED) or any(a["content"] == p for a in added):
            continue
        tid = vocab.get(p)
        if tid is None:
            tid, next_id = next_id, next_id + 1
        special = t == CONTROL or (kind == "gemma" and p in _GEMMA_SPECIAL)
        added.append({"id": tid, "content": p, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": special})

    replace_decoder = {"type": "Replace", "pattern": {"String": _REPLACEMENT}, "content": " "}
    if kind == "llama":
        if legacy:
            steps = [{"type": "Prepend", "prepend": _REPLACEMENT}] if add_prefix_space else []
            steps.append({"type": "Replace", "pattern": {"String": " "}, "content": _REPLACEMENT})
            normalizer = {"type": "Sequence", "normalizers": steps}
            pre_tokenizer = None
        else:
            normalizer = None
            pre_tokenizer = {"type": "Metaspace", "replacement": _REPLACEMENT,
                             "prepend_scheme": "first" if add_prefix_space else "never",
                             "split": False}
        steps = [replace_decoder, {"type": "ByteFallback"}, {"type": "Fuse"}]
        if add_prefix_space:
            steps.append({"type": "Strip", "content": " ", "start": 1, "stop": 0})
    else:
        normalizer = {"type": "Replace", "pattern": {"String": " "}, "content": _REPLACEMENT}
        pre_tokenizer = {"type": "Split", "pattern": {"String": " "},
                         "behavior": "MergedWithPrevious", "invert": False}
        steps = [replace_decoder, {"type": "ByteFallback"}, {"type": "Fuse"}]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": normalizer, "pre_tokenizer": pre_tokenizer, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": steps},
        "model": {"type": "BPE", "dropout": None, "unk_token": proto.unk_piece,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    return spec, specials
