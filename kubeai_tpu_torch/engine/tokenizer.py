"""Tokenizers (port of kubeai_tpu/engine/tokenizer.py).

The byte-level tokenizer keeps the whole stack hermetic. The HF tokenizer
waits for the port's weight loading (ROADMAP queue 1: HF tokenizer).
"""

from __future__ import annotations


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
