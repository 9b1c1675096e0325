"""The port's SentencePiece ``tokenizer.model`` reader against transformers'
own conversion of the same proto, on the CPU.

The JAX package hands a directory with only a ``tokenizer.model`` to
``transformers.AutoTokenizer``, which needs ``sentencepiece``; no machine
here has it, so the JAX ``load_tokenizer`` raises on such a directory
(``test_jax_load_tokenizer_needs_sentencepiece``). With ``sentencepiece``
installed, AutoTokenizer runs ``LlamaConverter`` / ``GemmaConverter`` on the
slow tokenizer; that conversion is the reference here. It runs with one
stub: ``SentencePieceExtractor.__init__``, the only place the converters
need the ``sentencepiece`` library, reads the pieces from the proto. The
protos are written with ``transformers.utils.sentencepiece_model_pb2_new``
(and the port's own writer is checked against it).

Three protos: a Llama-2 style BPE (byte fallback, dummy prefix; legacy
true and false, add_prefix_space true and false), a Gemma style one (no
dummy prefix, whitespace-run pieces, no tab piece), and one with
user-defined, control and unused pieces and only the ASCII byte pieces
(unknown characters fuse into <unk>). On a seeded corpus (ASCII, accents,
CJK, emoji, whitespace runs, characters outside the vocabulary) the
port's encode ids and decode text equal the reference's, and the
IncrementalDetokenizer's stream equals the full decode.
"""

import collections
import json

import numpy as np
import pytest
from transformers import PreTrainedTokenizerFast
from transformers import convert_slow_tokenizer as cst
from transformers.utils import sentencepiece_model_pb2_new as pb2

from kubeai_tpu.engine import tokenizer as jtok
from kubeai_tpu_torch.engine import spm
from kubeai_tpu_torch.engine import tokenizer as tt

TRAIN = (
    "The quick brown fox jumps over the lazy dog. Operators serve open models to users "
    "who pay for the first token. Héllo wörld, café au lait; naïve façade. "
    "日本語のテキスト。 Numbers 1234567 and 3.14159. def serve(request):\n    return "
    "engine.generate(request.prompt)\n\nThe the then there these those other mother. "
)
# Characters the protos give no piece of their own: byte fallback (or
# <unk>) must take them.
LEFT_OUT = set("ö語🙂ñ")

WORDS = ("the", "quick", "fox", "serve", "token", "users", "héllo", "wörld", "naïve", "日本",
         "テキスト", "🙂", "ünïcödé", "ok", "x²", "Ⅻ", "<s>", "</s>", "<|user|>", "@@", "<ctrl>",
         "hello", "world", "ñandú", "1234", "3.14", "a.b", "'s", "(", ")")
SPACES = (" ", " ", " ", "  ", "   ", "\t", "\n", "\n\n", " \n ", "")


def corpus(seed=0, n=40) -> list[str]:
    """Seeded texts over WORDS joined by SPACES, with leading and trailing
    whitespace in some."""
    g = np.random.default_rng(seed)
    out = ["hello world", "hé wörld!", "  hello", " ", "", "\t\tindented\n", "🙂🙂 emoji",
           "<s>hello</s> world", "a <|user|> b @@ c <ctrl> d"]
    for _ in range(n):
        k = int(g.integers(1, 12))
        parts = []
        for _ in range(k):
            parts.append(str(g.choice(WORDS)))
            parts.append(str(g.choice(SPACES)))
        out.append("".join(parts))
    return out


def _learn(words: collections.Counter, n: int) -> list[str]:
    """*n* BPE merges (most frequent pair first, ties to the smaller pair)
    over *words* (tuples of symbols): the merged pieces in order."""
    learned = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs, key=lambda pr: (-pairs[pr], pr))
        learned.append(best[0] + best[1])
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return learned


def _pieces(style: str) -> list[tuple[str, float, int]]:
    """The pieces of a *style* ("llama", "gemma", "extra") proto."""
    if style == "gemma":
        text = TRAIN.replace(" ", "▁")
        words = collections.Counter(tuple(w) for w in text.replace("▁", " ▁").split(" ") if w)
        head = [("<pad>", 0.0, spm.CONTROL), ("<eos>", 0.0, spm.CONTROL),
                ("<bos>", 0.0, spm.CONTROL), ("<unk>", 0.0, spm.UNKNOWN),
                ("<start_of_turn>", 0.0, spm.USER_DEFINED), ("<end_of_turn>", 0.0, spm.USER_DEFINED)]
        extra = ["▁▁", "▁▁▁", "▁▁▁▁", "\n", "\n\n", "\n▁▁▁▁"]
    else:
        words = collections.Counter(tuple("▁" + w) for w in TRAIN.split() if w)
        head = [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL), ("</s>", 0.0, spm.CONTROL)]
        extra = ["▁▁", "▁▁▁▁"]
    n_bytes = 128 if style == "extra" else 256
    pieces = head + [(f"<0x{b:02X}>", 0.0, spm.BYTE) for b in range(n_bytes)]
    if style == "extra":
        pieces += [("<|user|>", 0.0, spm.USER_DEFINED), ("@@", 0.0, spm.USER_DEFINED),
                   ("<ctrl>", 0.0, spm.CONTROL), ("<unused_0>", 0.0, spm.UNUSED)]
    learned = _learn(words, 120)
    seen = {p for p, _, _ in pieces}
    body = [p for p in extra + learned if p not in seen]
    pieces += [(p, -float(i), spm.NORMAL) for i, p in enumerate(body)]
    seen |= set(body)
    chars = sorted({c for c in TRAIN.replace(" ", "▁") if c not in LEFT_OUT} - seen - {"\t"})
    pieces += [(c, -float(len(body) + i), spm.NORMAL) for i, c in enumerate(chars)]
    return pieces


def _proto(style: str, model_type: int = spm.BPE):
    m = pb2.ModelProto()
    for p, s, t in _pieces(style):
        sp = m.pieces.add()
        sp.piece, sp.score, sp.type = p, s, t
    m.trainer_spec.model_type = model_type
    m.trainer_spec.vocab_size = len(m.pieces)
    m.trainer_spec.byte_fallback = True
    if style == "gemma":
        m.trainer_spec.unk_id, m.trainer_spec.bos_id, m.trainer_spec.eos_id = 3, 2, 1
        m.trainer_spec.pad_id = 0
        m.normalizer_spec.add_dummy_prefix = False
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.remove_extra_whitespaces = False
    return m


class _FakeSP:
    """What SentencePieceExtractor reads of a SentencePieceProcessor."""

    def __init__(self, proto):
        self._pieces = [p.piece for p in proto.pieces]

    def id_to_piece(self, i):
        return self._pieces[i]

    def GetPieceSize(self):
        return len(self._pieces)


class _Slow:
    """The slow tokenizer's attributes the converters read."""

    def __init__(self, vocab_file, proto, legacy, add_prefix_space, specials):
        self.vocab_file, self.legacy, self.add_prefix_space = vocab_file, legacy, add_prefix_space
        self._proto = proto
        for k, v in specials.items():
            setattr(self, k, v)

    def convert_ids_to_tokens(self, i):
        return self._proto.pieces[i].piece


SPECIALS = {"llama": {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"},
            "gemma": {"bos_token": "<bos>", "eos_token": "<eos>", "unk_token": "<unk>",
                      "pad_token": "<pad>"}}


@pytest.fixture
def stub_extractor(monkeypatch):
    def init(self, model):
        m = pb2.ModelProto()
        with open(model, "rb") as f:
            m.ParseFromString(f.read())
        self.sp = _FakeSP(m)

    monkeypatch.setattr(cst.SentencePieceExtractor, "__init__", init)


def _case(tmp_path, style, legacy=None, add_prefix_space=None):
    """(directory, reference tokenizer, reference tokenizer.json) of a
    *style* proto under a tokenizer_config with *legacy* and
    *add_prefix_space* (None: absent)."""
    kind = "gemma" if style == "gemma" else "llama"
    proto = _proto(style)
    d = tmp_path / f"{style}-{legacy}-{add_prefix_space}"
    d.mkdir()
    (d / "tokenizer.model").write_bytes(proto.SerializeToString())
    cfg = {"tokenizer_class": "GemmaTokenizer" if kind == "gemma" else "LlamaTokenizer",
           **SPECIALS[kind]}
    if legacy is not None:
        cfg["legacy"] = legacy
    if add_prefix_space is not None:
        cfg["add_prefix_space"] = add_prefix_space
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    slow = _Slow(str(d / "tokenizer.model"), proto, True if legacy is None else legacy,
                 True if add_prefix_space is None else add_prefix_space, SPECIALS[kind])
    conv = (cst.GemmaConverter if kind == "gemma" else cst.LlamaConverter)(slow)
    backend = conv.converted()
    ref = PreTrainedTokenizerFast(tokenizer_object=backend, clean_up_tokenization_spaces=False,
                                  **SPECIALS[kind])
    return d, ref, json.loads(backend.to_str())


CASES = [("llama", None, None), ("llama", False, None), ("llama", True, False),
         ("llama", False, False), ("gemma", None, None), ("extra", None, None),
         ("extra", False, None)]


@pytest.mark.parametrize("style,legacy,add_prefix_space", CASES)
def test_conversion_equals_transformers(tmp_path, stub_extractor, style, legacy,
                                        add_prefix_space):
    d, ref, ref_json = _case(tmp_path, style, legacy, add_prefix_space)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    spec, _ = spm.tokenizer_json(str(d), cfg)
    for key in ("normalizer", "pre_tokenizer", "decoder", "added_tokens"):
        assert spec[key] == ref_json[key], key
    assert spec["model"] == ref_json["model"]
    tok = tt.load_tokenizer(str(d))
    assert isinstance(tok, tt.HFTokenizer)
    assert tok.vocab_size == len(ref)
    assert (tok.bos_id, tok.eos_id) == (ref.bos_token_id, ref.eos_token_id)
    for text in corpus():
        ids = tok.encode(text, add_bos=False)
        assert ids == ref.encode(text, add_special_tokens=False), text
        assert tok.encode(text) == [ref.bos_token_id] + ids
        want = ref.decode(ids, skip_special_tokens=True)
        assert tok.decode(ids) == want, text
        det = tt.IncrementalDetokenizer(tok)
        streamed = "".join(det.push(i) for i in ids)
        assert streamed == det.text() == want, text


def test_reference_examples(tmp_path, stub_extractor):
    """The corpus reaches byte fallback, <unk> fusion and whitespace runs
    on the protos (so the equality above covers them)."""
    d, ref, _ = _case(tmp_path, "llama")
    tok = tt.load_tokenizer(str(d))
    assert any(tok._id_to_token[i].startswith("<0x") for i in tok.encode("wörld 🙂"))
    assert tok.decode(tok.encode("  hello")) == "  hello"
    d, ref, _ = _case(tmp_path, "extra")
    tok = tt.load_tokenizer(str(d))
    ids = tok.encode("ñö🙂 @@", add_bos=False)
    assert ids.count(0) == 1 and ids == ref.encode("ñö🙂 @@", add_special_tokens=False)
    d, ref, ref_json = _case(tmp_path, "gemma")
    tok = tt.load_tokenizer(str(d))
    assert ref_json["model"]["vocab"]["\t"] == tok._model.vocab["\t"]
    assert tok.encode("\t\tx", add_bos=False)[:2] == [tok._model.vocab["\t"]] * 2


@pytest.mark.parametrize("style", ["llama", "gemma", "extra"])
def test_proto_reader_and_writer_equal_protobuf(style):
    proto = _proto(style)
    m = spm.read_model_proto(proto.SerializeToString())
    assert m.pieces == [(p.piece, p.score, p.type) for p in proto.pieces]
    ts, ns = proto.trainer_spec, proto.normalizer_spec
    assert (m.model_type, m.vocab_size, m.byte_fallback) == (ts.model_type, ts.vocab_size,
                                                             ts.byte_fallback)
    assert (m.unk_id, m.bos_id, m.eos_id, m.pad_id) == (ts.unk_id, ts.bos_id, ts.eos_id,
                                                        ts.pad_id)
    assert (m.unk_piece, m.bos_piece, m.eos_piece, m.pad_piece) == (
        ts.unk_piece, ts.bos_piece, ts.eos_piece, ts.pad_piece)
    assert (m.add_dummy_prefix, m.remove_extra_whitespaces, m.escape_whitespaces) == (
        ns.add_dummy_prefix, ns.remove_extra_whitespaces, ns.escape_whitespaces)
    back = pb2.ModelProto()
    back.ParseFromString(spm.encode_model_proto(m))
    assert spm.read_model_proto(back.SerializeToString()) == m
    assert back.trainer_spec.pad_id == ts.pad_id  # a negative int32 round trip


def test_defaults_without_a_config(tmp_path, stub_extractor):
    """No tokenizer_config.json: the converter comes from config.json's
    model_type and the special tokens are the tokenizer class's."""
    d, ref, _ = _case(tmp_path, "llama")
    (d / "tokenizer_config.json").unlink()
    (d / "config.json").write_text(json.dumps({"model_type": "mistral"}))
    tok = tt.load_tokenizer(str(d))
    assert (tok.bos_id, tok.eos_id) == (1, 2)
    for text in corpus(1, 10):
        assert tok.encode(text, add_bos=False) == ref.encode(text, add_special_tokens=False)


def test_tokenizer_json_wins(tmp_path, stub_extractor, monkeypatch):
    """A directory with both files reads tokenizer.json, as transformers
    does: the SentencePiece model is not opened."""
    d, ref, ref_json = _case(tmp_path, "gemma")
    llama = _proto("llama")
    (d / "tokenizer.model").write_bytes(llama.SerializeToString())
    (d / "tokenizer.json").write_text(json.dumps(ref_json))

    def refuse(*a, **k):
        raise AssertionError("tokenizer.model was read")

    monkeypatch.setattr(spm, "tokenizer_json", refuse)
    tok = tt.load_tokenizer(str(d))
    for text in corpus(2, 10):
        assert tok.encode(text, add_bos=False) == ref.encode(text, add_special_tokens=False)


def test_unigram_and_tiktoken_refused(tmp_path):
    uni = tmp_path / "unigram"
    uni.mkdir()
    (uni / "tokenizer.model").write_bytes(_proto("llama", model_type=spm.UNIGRAM)
                                          .SerializeToString())
    with pytest.raises(NotImplementedError, match="Unigram.*ROADMAP"):
        tt.load_tokenizer(str(uni))
    tik = tmp_path / "tiktoken"
    tik.mkdir()
    (tik / "tokenizer.model").write_text("IQ== 0\nIg== 1\nIw== 2\n")
    with pytest.raises(NotImplementedError, match="tiktoken.*ROADMAP"):
        tt.load_tokenizer(str(tik))
    cls = tmp_path / "t5"
    cls.mkdir()
    (cls / "tokenizer.model").write_bytes(_proto("llama").SerializeToString())
    (cls / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "T5Tokenizer"}))
    with pytest.raises(NotImplementedError, match="T5Tokenizer"):
        tt.load_tokenizer(str(cls))


def test_jax_load_tokenizer_needs_sentencepiece(tmp_path):
    """The JAX package's load_tokenizer cannot read such a directory here:
    AutoTokenizer needs sentencepiece, which this machine lacks (so the
    reference above is transformers' converter, run with the stub)."""
    with pytest.raises(ImportError):
        import sentencepiece  # noqa: F401
    d = tmp_path / "sp"
    d.mkdir()
    (d / "tokenizer.model").write_bytes(_proto("llama").SerializeToString())
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizer", **SPECIALS["llama"]}))
    with pytest.raises(Exception) as e:
        jtok.load_tokenizer(str(d))
    assert "sentencepiece" in str(e.value).lower() or "SentencePiece" in repr(e.value)
    assert isinstance(tt.load_tokenizer(str(d)), tt.HFTokenizer)
