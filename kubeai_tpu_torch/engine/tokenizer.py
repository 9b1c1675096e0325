"""Tokenizers (port of kubeai_tpu/engine/tokenizer.py).

The byte-level tokenizer keeps the whole stack hermetic. A checkpoint's
own tokenizer is read from its ``tokenizer.json`` by :class:`HFTokenizer`,
which does what the JAX package's ``transformers.AutoTokenizer`` wrapper
does without ``transformers``, ``tokenizers`` or ``regex`` (the card's
machine has none): the BPE models, normalizers, pre-tokenizers and
decoders of the catalog's tokenizers (Llama-3, Qwen2, Gemma, Mistral),
added and special tokens, and the chat template of
``tokenizer_config.json`` rendered with ``jinja2`` as transformers renders
it. Any other component raises and names itself. A directory with only a
SentencePiece ``tokenizer.model`` is refused (ROADMAP queue 1 item 5b).
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata

TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte value; specials above.

    vocab: 0..255 bytes, 256 = BOS, 257 = EOS, 258 = PAD.
    """

    bos_id = 256
    eos_id = 257
    pad_id = 258
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


# ---------------------------------------------------------------------------
# Regular expressions: the Oniguruma patterns of tokenizer.json in Python's re


# Unicode White_Space: what Oniguruma's \s matches (Python's differs on
# U+001C..U+001F).
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
                (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
                (0x3000, 0x3000))


def _esc(cp: int) -> str:
    return f"\\u{cp:04x}" if cp <= 0xFFFF else f"\\U{cp:08x}"


def _ranges_body(ranges) -> str:
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


@functools.lru_cache(maxsize=None)
def _category_body(name: str) -> str:
    """The body of a character class matching Unicode general category
    *name* ("L", "N", "Lu", ...), built from unicodedata: Python's re has
    no \\p{..}, and its usual stand-ins ([^\\W\\d_] for letters) also match
    the No / Nl numerics."""
    ranges: list[list[int]] = []
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)).startswith(name):
            if ranges and ranges[-1][1] == cp - 1:
                ranges[-1][1] = cp
            else:
                ranges.append([cp, cp])
    if not ranges:
        raise NotImplementedError(f"tokenizer regex: unknown Unicode category \\p{{{name}}}")
    return _ranges_body(ranges)


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of tokenizer.json as a Python re pattern that
    matches the same strings: \\p{X} / \\P{X} become explicit classes of the
    Unicode category, \\s / \\S the White_Space set. \\w, \\W, \\b and \\B
    (whose Unicode meaning differs between the engines) raise."""
    out: list[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            body = neg = None
            if nxt in "pP":
                if pattern[i + 2 : i + 3] == "{":
                    j = pattern.index("}", i)
                    name, i = pattern[i + 3 : j], j + 1
                else:
                    name, i = pattern[i + 2], i + 3
                body, neg = _category_body(name), nxt == "P"
            elif nxt in "sS":
                body, neg, i = _ranges_body(_WHITE_SPACE), nxt == "S", i + 2
            elif nxt in "wWbB":
                raise NotImplementedError(f"tokenizer regex: \\{nxt} is not supported")
            else:
                out.append(pattern[i : i + 2])
                i += 2
                continue
            if in_class and neg:
                raise NotImplementedError("tokenizer regex: a negated class inside a class")
            out.append(body if in_class else f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[" and not in_class:
            in_class = True
        elif c == "]" and in_class and out[-1] not in ("[", "[^"):
            in_class = False
        if in_class and c == "^" and out and out[-1] == "[":
            out[-1] = "[^"
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _compile(pattern: dict):
    """A tokenizer.json pattern ({"String": s} or {"Regex": r})."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        return re.compile(translate_regex(pattern["Regex"]))
    raise NotImplementedError(f"tokenizer pattern {pattern!r} is not supported")


def _find_matches(regex, text: str) -> list[tuple[int, int, bool]]:
    """(start, end, is_match) segments covering *text* (tokenizers'
    Pattern::find_matches)."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in regex.finditer(text):
        s, e = m.span()
        if s == e:
            continue
        if prev != s:
            out.append((prev, s, False))
        out.append((s, e, True))
        prev = e
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split(text: str, regex, behavior: str, invert: bool = False) -> list[tuple[int, int]]:
    """The pieces of *text* that SplitDelimiterBehavior *behavior* keeps
    (tokenizers' NormalizedString::split), as (start, end)."""
    segs = [(s, e, m != invert) for s, e, m in _find_matches(regex, text)]
    if behavior == "Removed":
        return [(s, e) for s, e, m in segs if not m]
    if behavior == "Isolated":
        return [(s, e) for s, e, _ in segs]
    out: list[list[int]] = []
    prev_match = False
    if behavior == "Contiguous":
        for s, e, m in segs:
            if m == prev_match and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_match = m
    elif behavior == "MergedWithPrevious":
        for s, e, m in segs:
            if m and not prev_match and out:
                out[-1][1] = e
            else:
                out.append([s, e])
            prev_match = m
    elif behavior == "MergedWithNext":
        for s, e, m in reversed(segs):
            if m and not prev_match and out:
                out[-1][0] = s
            else:
                out.append([s, e])
            prev_match = m
        out.reverse()
    else:
        raise NotImplementedError(f"tokenizer split behavior {behavior!r} is not supported")
    return [(s, e) for s, e in out]


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character map (the ByteLevel alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# GPT-2's pre-tokenizer regex: ByteLevel's use_regex.
_GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


# ---------------------------------------------------------------------------
# Components. A piece is (text, first): first is True only for the piece
# that starts the input (Metaspace's prepend_scheme "first").


def _normalizer(spec):
    """str -> str of a tokenizer.json normalizer (None: identity)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]
        return lambda t: functools.reduce(lambda acc, f: f(acc), steps, t)
    if kind == "NFC":
        return lambda t: unicodedata.normalize("NFC", t)
    if kind == "Prepend":
        return lambda t, p=spec["prepend"]: p + t if t else t
    if kind == "Replace":
        rx, content = _compile(spec["pattern"]), spec["content"]
        return lambda t: rx.sub(lambda _: content, t)
    raise NotImplementedError(f"tokenizer.json normalizer {kind!r} is not supported")


def _pre_tokenizer(spec):
    """list of pieces -> list of pieces, of a tokenizer.json
    pre-tokenizer (None: identity)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]
        return lambda ps: functools.reduce(lambda acc, f: f(acc), steps, ps)
    if kind == "Split":
        rx = _compile(spec["pattern"])
        behavior, invert = spec["behavior"], spec.get("invert", False)

        def split(pieces):
            return [(t[s:e], first and s == 0) for t, first in pieces
                    for s, e in _split(t, rx, behavior, invert) if e > s]
        return split
    if kind == "ByteLevel":
        rx = re.compile(translate_regex(_GPT2_PATTERN)) if spec.get("use_regex", True) else None
        prefix = spec.get("add_prefix_space", False)
        table = _bytes_to_unicode()

        def byte_level(pieces):
            out = []
            for t, first in pieces:
                if prefix and not t.startswith(" "):
                    t = " " + t
                spans = _split(t, rx, "Isolated") if rx else [(0, len(t))]
                out += [("".join(table[b] for b in t[s:e].encode("utf-8")), first and s == 0)
                        for s, e in spans if e > s]
            return out
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True)
                          else "never")
        split_rx = re.compile(re.escape(rep)) if spec.get("split", True) else None

        def metaspace(pieces):
            out = []
            for t, first in pieces:
                t = t.replace(" ", rep)
                if not t.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
                    t = rep + t
                spans = _split(t, split_rx, "MergedWithNext") if split_rx else [(0, len(t))]
                out += [(t[s:e], first and s == 0) for s, e in spans if e > s]
            return out
        return metaspace
    raise NotImplementedError(f"tokenizer.json pre_tokenizer {kind!r} is not supported")


def _decoder(spec):
    """list of token strings -> list of strings, of a tokenizer.json
    decoder (tokenizers' decode_chain; the caller joins the result)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_decoder(s) for s in spec["decoders"]]
        return lambda toks: functools.reduce(lambda acc, f: f(acc), steps, toks)
    if kind == "ByteLevel":
        inv = {c: b for b, c in _bytes_to_unicode().items()}

        def byte_level(toks):
            data = bytearray()
            for t in toks:
                if all(c in inv for c in t):
                    data += bytes(inv[c] for c in t)
                else:
                    data += t.encode("utf-8")
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        rx, content = _compile(spec["pattern"]), spec["content"]
        return lambda toks: [rx.sub(lambda _: content, t) for t in toks]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda toks: ["".join(toks)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]
        return lambda toks: [_strip(t, content, start, stop) for t in toks]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True)
                          else "never")

        def metaspace(toks):
            # As tokenizers does: the first token drops every replacement
            # char (its prepended space), the others turn them into spaces.
            return [t.replace(rep, "" if i == 0 and scheme != "never" else " ")
                    for i, t in enumerate(toks)]
        return metaspace
    raise NotImplementedError(f"tokenizer.json decoder {kind!r} is not supported")


def _byte_fallback(toks: list[str]) -> list[str]:
    """<0xXX> tokens back to bytes: each run decoded as UTF-8, or one
    U+FFFD per byte when the run is not valid UTF-8."""
    out, run = [], bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for t in toks:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _strip(t: str, content: str, start: int, stop: int) -> str:
    lo = 0
    while lo < min(start, len(t)) and t[lo] == content:
        lo += 1
    hi = len(t)
    while len(t) - hi < stop and hi > lo and t[hi - 1] == content:
        hi -= 1
    return t[lo:hi]


class _BPE:
    """tokenizer.json's BPE model: merges applied in rank order through a
    priority queue (tokenizers' Word::merge_all), optional byte fallback
    for characters outside the vocab, ignore_merges, and a cache per
    pre-token."""

    CACHE = 1 << 16

    def __init__(self, spec: dict):
        if spec.get("type") != "BPE":
            raise NotImplementedError(f"tokenizer.json model {spec.get('type')!r} is not supported")
        for opt in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(opt):
                raise NotImplementedError(f"tokenizer.json BPE option {opt} is not supported")
        self.vocab: dict[str, int] = spec["vocab"]
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        unk = spec.get("unk_token")
        self.unk_id = self.vocab.get(unk) if unk is not None else None
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
            except KeyError:
                raise ValueError(f"tokenizer.json merge {m!r} is outside the vocab") from None
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        got = self._cache.get(word)
        if got is None:
            if len(self._cache) >= self.CACHE:
                self._cache.clear()
            got = self._cache[word] = self._tokenize(word)
        return got

    def _tokenize(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: list[int] = []
        last_unk = False
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                syms.append(tid)
                last_unk = False
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    syms += ids
                    last_unk = False
                    continue
            if self.unk_id is not None:
                if not (self.fuse_unk and last_unk):
                    syms.append(self.unk_id)
                last_unk = True
        return self._merge(syms)

    def _merge(self, c: list[int]) -> list[int]:
        n = len(c)
        if n < 2:
            return c
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            right = nxt[pos]
            if not alive[pos] or right == -1:
                continue
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(c, alive) if a]


_SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                  "mask_token")


def _content(tok):
    """A token of tokenizer_config.json: a string or an AddedToken dict."""
    return tok.get("content") if isinstance(tok, dict) else tok


class HFTokenizer:
    """A checkpoint's tokenizer from its tokenizer.json (and
    tokenizer_config.json / special_tokens_map.json / chat_template.jinja
    where present), with the JAX package's HFTokenizer interface: encode
    without the post-processor's special tokens (BOS prepended by
    *add_bos*), decode skipping special tokens, and the chat template."""

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        cfg = _read_json(os.path.join(path, "tokenizer_config.json"))
        for k, v in _read_json(os.path.join(path, "special_tokens_map.json")).items():
            cfg.setdefault(k, v)
        if "model" not in spec:
            raise ValueError(f"{path}/tokenizer.json has no model")
        self._model = _BPE(spec["model"])
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode = _decoder(spec.get("decoder"))
        self._clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))

        # Added tokens: tokenizer.json's, then tokenizer_config.json's
        # added_tokens_decoder, then special tokens the config names that
        # neither holds (new ids past the vocab), as transformers adds them.
        self._added: dict[str, dict] = {}
        for t in spec.get("added_tokens", []):
            self._added[t["content"]] = dict(t)
        for sid, t in (cfg.get("added_tokens_decoder") or {}).items():
            self._added.setdefault(t["content"], {**t, "id": int(sid)})["special"] = \
                t.get("special", False)
        vocab = self._model.vocab
        self._specials = {attr: _content(cfg.get(attr)) for attr in _SPECIAL_ATTRS
                          if _content(cfg.get(attr))}
        extra = [_content(t) for t in cfg.get("additional_special_tokens") or []]
        for content in list(self._specials.values()) + extra:
            if content not in self._added:
                tid = vocab.get(content)
                if tid is None:
                    tid = len(set(vocab) | set(self._added))
                self._added[content] = {"id": tid, "content": content, "special": True}
        self.vocab_size = len(set(vocab) | set(self._added))
        self._id_to_token = {i: t for t, i in vocab.items()}
        self._id_to_token.update({a["id"]: c for c, a in self._added.items()})
        self._special_set = {c for c, a in self._added.items() if a.get("special")}
        self._raw_split = self._matcher([a for a in self._added.values()
                                         if not a.get("normalized", False)])
        self._norm_split = self._matcher([a for a in self._added.values()
                                          if a.get("normalized", False)])
        self._special_map = dict(self._specials)
        if extra:
            self._special_map["additional_special_tokens"] = extra

        self.bos_id = self._token_id(self._specials.get("bos_token"))
        self.eos_id = self._token_id(self._specials.get("eos_token"))
        self.pad_id = self._token_id(self._specials.get("pad_token")) or self.eos_id
        template = cfg.get("chat_template")
        jinja_file = os.path.join(path, "chat_template.jinja")
        if os.path.exists(jinja_file):
            with open(jinja_file, encoding="utf-8") as f:
                template = f.read()
        elif isinstance(template, list):
            template = next((t["template"] for t in template if t.get("name") == "default"), None)
        self.chat_template: str | None = template

    def _token_id(self, content: str | None) -> int | None:
        if content is None:
            return None
        if content in self._added:
            return self._added[content]["id"]
        return self._model.vocab.get(content)

    @staticmethod
    def _matcher(tokens: list[dict]):
        """A regex of the added tokens, longest first (aho-corasick's
        leftmost-longest), or None."""
        if not tokens:
            return None
        contents = sorted({t["content"] for t in tokens}, key=len, reverse=True)
        return re.compile("|".join(re.escape(c) for c in contents))

    def _split_added(self, text: str, regex) -> list[tuple[str, int | None, int]]:
        """(piece, added token id or None, start) over *text*: the added
        tokens *regex* finds, with their lstrip / rstrip / single_word
        rules (tokenizers' AddedVocabulary::find_matches), and the text
        between them."""
        if regex is None:
            return [(text, None, 0)] if text else []
        out, at = [], 0
        for m in regex.finditer(text):
            tok = self._added[m.group()]
            start, stop = m.span()
            if tok.get("single_word") and (
                    (start > 0 and _is_word(text[start - 1]))
                    or (stop < len(text) and _is_word(text[stop]))):
                continue
            if tok.get("lstrip"):
                s = start
                while s > 0 and text[s - 1].isspace():
                    s -= 1
                start = max(s, at)
            if tok.get("rstrip"):
                while stop < len(text) and text[stop].isspace():
                    stop += 1
            if at < start:
                out.append((text[at:start], None, at))
            out.append((text[start:stop], tok["id"], start))
            at = stop
        if at < len(text):
            out.append((text[at:], None, at))
        return out

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids: list[int] = []
        for piece, tid, start in self._split_added(text, self._raw_split):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self._normalize(piece) if self._normalize else piece
            for sub, sid, sub_start in self._split_added(norm, self._norm_split):
                if sid is not None:
                    ids.append(sid)
                    continue
                pieces = [(sub, start == 0 and sub_start == 0)]
                if self._pre_tokenize:
                    pieces = self._pre_tokenize(pieces)
                for word, _ in pieces:
                    ids += self._model.tokenize(word)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        tokens = [t for t in (self._id_to_token.get(int(i)) for i in ids)
                  if t is not None and t not in self._special_set]
        text = "".join(self._decode(tokens)) if self._decode else " ".join(tokens)
        if self._clean_up:
            text = (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
                    .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
                    .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
                    .replace(" 're", "'re"))
        return text

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        """The checkpoint's chat template rendered as transformers renders
        it (a sandboxed jinja2 environment with trim_blocks, lstrip_blocks
        and loop controls; raise_exception, strftime_now and a tojson that
        does not escape HTML; the special tokens in the context). Without a
        template, or when rendering fails, the byte tokenizer's template,
        as the JAX package falls back."""
        try:
            if not self.chat_template:
                raise ValueError("the tokenizer has no chat template")
            return _compiled_template(self.chat_template).render(
                messages=messages, tools=None, documents=None,
                add_generation_prompt=add_generation_prompt, **self._special_map)
        except Exception:
            return ByteTokenizer.apply_chat_template(self, messages, add_generation_prompt)


def _is_word(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@functools.lru_cache(maxsize=8)
def _compiled_template(source: str):
    import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                          sort_keys=sort_keys)

    class Generation(jinja2.ext.Extension):
        """{% generation %}...{% endgeneration %} renders its body (the
        tag transformers uses to mark assistant tokens)."""

        tags = {"generation"}

        def parse(self, parser):
            lineno = next(parser.stream).lineno
            body = parser.parse_statements(("name:endgeneration",), drop_needle=True)
            call = jinja2.nodes.CallBlock(self.call_method("_body"), [], [], body)
            return call.set_lineno(lineno)

        def _body(self, caller):
            return caller()

    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[Generation, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = lambda fmt: datetime.datetime.now().strftime(fmt)
    return env.from_string(source)


def load_tokenizer(path: str | None):
    """The tokenizer of a model directory: the byte tokenizer when *path*
    is None or "byte" or the directory has no tokenizer files, else
    :class:`HFTokenizer` over its tokenizer.json. A directory whose only
    tokenizer is a SentencePiece tokenizer.model (or that has a
    tokenizer_config.json and no tokenizer.json) raises."""
    if path in (None, "byte"):
        return ByteTokenizer()
    found = [f for f in TOKENIZER_FILES if os.path.exists(os.path.join(path, f))]
    if not found:
        return ByteTokenizer()
    if "tokenizer.json" not in found:
        raise NotImplementedError(
            f"{path} has {', '.join(found)} but no tokenizer.json: reading a SentencePiece "
            "tokenizer.model is not ported (ROADMAP queue 1 item 5b)"
        )
    return HFTokenizer(path)


class IncrementalDetokenizer:
    """Streams text from a growing id list, emitting only complete UTF-8
    chunks: only a window from the last confirmed boundary is re-decoded,
    and a trailing replacement char marks a split sequence to hold back."""

    CONTEXT = 4  # confirmed tokens kept in the decode window

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._committed = ""
        self._confirmed = 0

    def _pending_delta(self) -> tuple[str, bool]:
        ctx = max(0, self._confirmed - self.CONTEXT)
        prefix = self._tok.decode(self._ids[ctx : self._confirmed]) if self._confirmed > ctx else ""
        full = self._tok.decode(self._ids[ctx:])
        return full[len(prefix) :], full.endswith("�")

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        delta, incomplete = self._pending_delta()
        if incomplete:
            return ""
        self._committed += delta
        self._confirmed = len(self._ids)
        return delta

    def text(self) -> str:
        """Full text including any incomplete tail (as replacement chars)."""
        delta, _ = self._pending_delta()
        return self._committed + delta
