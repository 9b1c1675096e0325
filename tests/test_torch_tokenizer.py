"""The port's HFTokenizer (kubeai_tpu_torch.engine.tokenizer), which reads
tokenizer.json without transformers, against the JAX package's
HFTokenizer (transformers.AutoTokenizer) on the same directories.

The tokenizers are built in process with the `tokenizers` package, no
download: a byte-level BPE with Llama-3's Split pattern (ignore_merges,
clean-up of tokenization spaces, Llama-3's special tokens and chat
template), the same with Qwen2's pattern and NFC, a SentencePiece-style
BPE with byte fallback (Prepend / Replace normalizers; Replace,
ByteFallback, Fuse and Strip decoders), and one with a Metaspace
pre-tokenizer and decoder whose chat template is a chat_template.jinja,
each trained on a small corpus.
encode, decode, the chat template and the streaming detokenizer must
equal the JAX package's on text with accents, CJK, long digit runs,
contractions, newlines, '²', 'Ⅻ' and special tokens."""

import json

import pytest
import tokenizers

from kubeai_tpu.engine.tokenizer import HFTokenizer as JHFTokenizer
from kubeai_tpu_torch.engine import tokenizer as tt

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{{ '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n' "
    "+ message['content'] | trim + '<|eot_id|>' }}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}"
    "{% endif %}")
SP_TEMPLATE = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if message['role'] == 'system' %}{{ raise_exception('no system role') }}{% endif %}"
    "{% if message['role'] == 'user' %}{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% else %}{{ message['content'] + eos_token }}{% endif %}{% endfor %}")

CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's a dog's life, isn't it?",
    "Héllo wörld, café au lait; naïve façade. Ça va? Über straße.",
    "日本語のテキストと中文文本。你好，世界！",
    "Numbers: 1234567890 and 3.14159, 2² + 3² = 13, Ⅻ o'clock, ¼ cup.",
    "We'll see; they're here, you've done it, I'm sure, he'd go.\n\nNew  paragraph\twith tabs.",
    "def f(x):\n    return x * 2  # comment\n",
] * 20

TEXTS = [
    "Hello world",
    "The café's naïve owner didn't say 'hi' — he'd left.",
    "日本語 text with ünïcödé and ASCII",
    "Digits 1234567 and 98765432109876, x² + yⅫ, ①②.",
    "Line one\nLine two\r\n\n  indented   spaces  \t tab",
    "I'M SURE THEY'LL COME, WE'VE SEEN IT'S TRUE. Don't .",
    "<|begin_of_text|>special<|eot_id|> tokens <|start_header_id|>user<|end_header_id|>",
    "<s>after a special token</s> and between <s> them",
    "  leading and trailing spaces   ",
    "emoji 🙂🚀 and rare 𝔘𝔫𝔦𝔠𝔬𝔡𝔢",
    "",
]

MESSAGES = [
    {"role": "user", "content": "Hi there! What's 2² + Ⅻ?"},
    {"role": "assistant", "content": "It is 16. 日本語も話せます。"},
    {"role": "user", "content": "  Thanks  "},
]


def _byte_level(path, pattern, nfc=False):
    from tokenizers import Regex, decoders, models, normalizers, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE(ignore_merges=True))
    if nfc:
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                "<|end_header_id|>", "<|eot_id|>"]
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=specials,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<|begin_of_text|>",
           "eos_token": "<|eot_id|>", "clean_up_tokenization_spaces": True,
           "chat_template": LLAMA3_TEMPLATE, "model_max_length": 131072}
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(path)


def _sentencepiece(path):
    """A BPE over '▁'-joined words with byte fallback for characters the
    trained alphabet lacks (the CJK and rare letters), as Llama-2 and
    Mistral tokenizer.json files are."""
    from tokenizers import decoders, models, normalizers, trainers

    norm = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok = tokenizers.Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
    tok.normalizer = norm
    trainer = trainers.BpeTrainer(vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"],
                                  limit_alphabet=60, show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    spec["model"]["byte_fallback"] = True
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    tok = tokenizers.Tokenizer.from_str(json.dumps(spec))  # still a valid tokenizer
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    cfg = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
           "unk_token": "<unk>", "chat_template": SP_TEMPLATE}
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(path)


def _metaspace(path):
    """Mistral's newer layout: a Metaspace pre-tokenizer (prepend only at
    the start of the text) and decoder, byte fallback, and the chat
    template in chat_template.jinja instead of tokenizer_config.json."""
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
    trainer = trainers.BpeTrainer(vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"],
                                  limit_alphabet=60, show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    spec = json.loads(tok.to_str())
    for b in range(256):
        spec["model"]["vocab"].setdefault(f"<0x{b:02X}>", len(spec["model"]["vocab"]))
    spec["model"]["byte_fallback"] = True
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "ByteFallback"},
        {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": True}]}
    tok = tokenizers.Tokenizer.from_str(json.dumps(spec))
    path.mkdir()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>"}))
    (path / "chat_template.jinja").write_text(SP_TEMPLATE)
    return str(path)


BUILDERS = {
    "llama3_byte_level": lambda p: _byte_level(p, LLAMA3_PATTERN),
    "qwen2_byte_level_nfc": lambda p: _byte_level(p, QWEN2_PATTERN, nfc=True),
    "sentencepiece_byte_fallback": _sentencepiece,
    "metaspace_jinja_file": _metaspace,
}


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def pair(request, tmp_path_factory):
    path = BUILDERS[request.param](tmp_path_factory.mktemp("tok") / request.param)
    return JHFTokenizer(path), tt.load_tokenizer(path)


def test_encode_decode_match_jax(pair):
    jt, pt = pair
    assert isinstance(pt, tt.HFTokenizer)
    assert (pt.bos_id, pt.eos_id, pt.pad_id, pt.vocab_size) == \
        (jt.bos_id, jt.eos_id, jt.pad_id, jt.vocab_size)
    for text in TEXTS + CORPUS[:6]:
        for add_bos in (True, False):
            ids = jt.encode(text, add_bos=add_bos)
            assert pt.encode(text, add_bos=add_bos) == ids, text
        assert pt.decode(ids) == jt.decode(ids), text
    # Every id alone, and ids that split multi-byte characters.
    for i in range(pt.vocab_size):
        assert pt.decode([i]) == jt.decode([i]), i
    ids = jt.encode("日本語🙂²Ⅻ", add_bos=False)
    for cut in range(len(ids) + 1):
        assert pt.decode(ids[:cut]) == jt.decode(ids[:cut])


def test_chat_template_matches_jax(pair):
    jt, pt = pair
    for add in (True, False):
        assert pt.apply_chat_template(MESSAGES, add) == jt.apply_chat_template(MESSAGES, add)
    # A template that raises falls back to the byte template, in both.
    system = [{"role": "system", "content": "be brief"}] + MESSAGES
    assert pt.apply_chat_template(system) == jt.apply_chat_template(system)


def test_incremental_detokenizer_equals_full_decode(pair):
    _, pt = pair
    text = "Streaming 日本語 text: naïve café², Ⅻ 🙂 done.\nNext line."
    ids = pt.encode(text, add_bos=True)
    detok = tt.IncrementalDetokenizer(pt)
    streamed = "".join(detok.push(i) for i in ids)
    assert streamed == detok.text() == pt.decode(ids)


def test_unicode_classes_are_exact():
    """\\p{L} and \\p{N} match exactly the letters and numbers: '²' (No)
    and 'Ⅻ' (Nl) are numbers, not letters, and '_' neither."""
    import re

    letters = re.compile(tt.translate_regex(r"\p{L}+"))
    numbers = re.compile(tt.translate_regex(r"\p{N}+"))
    for ch, is_letter, is_number in (("a", True, False), ("é", True, False),
                                     ("日", True, False), ("²", False, True),
                                     ("Ⅻ", False, True), ("5", False, True),
                                     ("_", False, False), (" ", False, False)):
        assert bool(letters.fullmatch(ch)) == is_letter, ch
        assert bool(numbers.fullmatch(ch)) == is_number, ch
    assert re.compile(tt.translate_regex(r"[^\s\p{L}]+")).fullmatch("²_!")


def test_refusals(tmp_path):
    only_model = tmp_path / "sp"
    only_model.mkdir()
    (only_model / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(NotImplementedError, match="tokenizer.model"):
        tt.load_tokenizer(str(only_model))
    for kind, spec in (
        ("model", {"model": {"type": "Unigram", "vocab": []}}),
        ("normalizer", {"normalizer": {"type": "NFKD"}, "model": {"type": "BPE", "vocab": {}}}),
        ("pre_tokenizer", {"pre_tokenizer": {"type": "Whitespace"},
                           "model": {"type": "BPE", "vocab": {}}}),
        ("decoder", {"decoder": {"type": "WordPiece"}, "model": {"type": "BPE", "vocab": {}}}),
    ):
        d = tmp_path / kind
        d.mkdir()
        (d / "tokenizer.json").write_text(json.dumps(spec))
        with pytest.raises(NotImplementedError, match=kind):
            tt.load_tokenizer(str(d))
    assert isinstance(tt.load_tokenizer(str(tmp_path)), tt.ByteTokenizer)
