"""CLIP's byte-level BPE tokenizer for the text tower.

The port's own copy of ``isegprobe_tpu/models/featurizers/clip_tokenizer.py``
(pure Python; the port imports nothing of the JAX package). The merge table
is data, not code: ``bpe_path`` names the ``bpe_simple_vocab_16e6.txt.gz``
gzip of OpenAI's CLIP (not in the repository, and required). The byte
alphabet, the token-split regex and the merge loop are the BPE
specification, which any CLIP-compatible tokenizer reproduces exactly.

Cleaning uses ``ftfy.fix_text`` where ftfy is installed, else
:func:`fix_text_offline`: the deterministic part of ftfy 6's default
pipeline (line breaks, escapes and control characters, width forms,
quotes, ligatures, NFC), vendored as tables, which agrees with ftfy on
well-formed text; only ftfy's repair of broken encodings is left out. The
split regex needs the ``regex`` package for its Unicode classes; without
it an ASCII form is used, which agrees on ASCII text.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# ---- vendored deterministic ftfy rules --------------------------------------
# ftfy.fix_text defaults applied by the reference's basic_clean
# (reference: maskclip/simple_tokenizer.py:50): for well-formed input the
# pipeline reduces to these deterministic rewrites + NFC normalization.

# uncurl_quotes: curly/slanted quotes -> ASCII
_QUOTE_TABLE = str.maketrans({
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
})
# fix_latin_ligatures: single-codepoint Latin ligatures -> letter sequences
_LIGATURE_TABLE = str.maketrans({
    "Ĳ": "IJ", "ĳ": "ij",
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "ft", "ﬆ": "st",
})
# fix_line_breaks: every line-break convention -> '\n'
_LINE_BREAKS = str.maketrans({
    "\r": "\n", "\x0b": "\n", "\x0c": "\n",
    "": "\n", " ": "\n", " ": "\n",
})
# remove_terminal_escapes: ANSI CSI sequences
_TERMINAL_ESCAPES = re.compile(r"\x1b\[[0-9;]*[mKH]")
# remove_control_chars: C0 (minus \t \n, \r handled by line breaks) + C1 +
# interlinear annotation / BOM-as-ZWNBSP
_CONTROL_CHARS = re.compile(
    "[\x00-\x08\x0e-\x1f\x7f\x80-\x9f￹-￻﻿]")


def fix_text_offline(text: str) -> str:
    """Deterministic stand-in for ``ftfy.fix_text`` (defaults) on well-formed
    text: line breaks, terminal escapes, control chars, surrogates,
    half/full-width forms (NFKC on the Halfwidth and Fullwidth Forms block),
    curly quotes, Latin ligatures, then NFC."""
    text = text.replace("\r\n", "\n").translate(_LINE_BREAKS)
    text = _TERMINAL_ESCAPES.sub("", text)
    text = _CONTROL_CHARS.sub("", text)
    # fix_surrogates: lone surrogates -> U+FFFD
    text = "".join(
        "�" if "\ud800" <= c <= "\udfff" else c for c in text)
    # fix_character_width: fullwidth/halfwidth compatibility forms
    if any("！" <= c <= "￮" for c in text):
        text = "".join(
            unicodedata.normalize("NFKC", c)
            if "！" <= c <= "￮" else c for c in text)
    text = text.translate(_QUOTE_TABLE).translate(_LIGATURE_TABLE)
    return unicodedata.normalize("NFC", text)


try:  # pragma: no cover - optional dep (and may be an empty test stub)
    import ftfy

    _fix_text = ftfy.fix_text
except (ImportError, AttributeError):  # pragma: no cover
    _fix_text = fix_text_offline

try:
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except (ImportError, AttributeError):  # pragma: no cover - stubbed/absent
    import re as _re

    # ASCII-equivalent fallback: identical on English prompts
    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
        _re.IGNORECASE,
    )


@functools.lru_cache()
def _byte_alphabet() -> Dict[int, str]:
    """The reversible byte->unicode table of byte-level BPE: printable bytes
    map to themselves, the rest to codepoints from 256 up (spec constant)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table = {b: chr(b) for b in keep}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _adjacent_pairs(parts: Sequence[str]) -> set:
    return set(zip(parts[:-1], parts[1:]))


class ClipTokenizer:
    """Byte-level BPE with the CLIP merge table.

    encode(): text -> merge ids; __call__(): batch -> padded [B, 77] int32
    context arrays with <|startoftext|>/<|endoftext|> framing (the model
    pools at the eot position = per-row argmax, since eot has the highest
    id)."""

    def __init__(self, bpe_path: str) -> None:
        lines = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # header line + exactly the 48894 merges the 49152-token vocab uses
        merges = [tuple(ln.split()) for ln in lines[1: 49152 - 256 - 2 + 1]]
        self._byte_enc = _byte_alphabet()
        base = list(self._byte_enc.values())
        vocab: List[str] = (base + [c + "</w>" for c in base]
                            + ["".join(m) for m in merges]
                            + ["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: t for t, i in self.encoder.items()}
        self._rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        # literal specials in input text must NOT be BPE-split (the word
        # regex matches them whole; reference pre-seeds its cache the same)
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    # ---- BPE core ------------------------------------------------------
    def _merge_word(self, token: str) -> str:
        """Greedily apply the lowest-rank merge until none applies."""
        hit = self._cache.get(token)
        if hit is not None:
            return hit
        parts: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(parts) > 1:
            pairs = _adjacent_pairs(parts)
            best = min(pairs, key=lambda p: self._rank.get(p, 1 << 30))
            if best not in self._rank:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = tuple(merged)
        out = " ".join(parts)
        self._cache[token] = out
        return out

    # ---- public API ----------------------------------------------------
    def clean(self, text: str) -> str:
        text = _fix_text(text)
        text = html.unescape(html.unescape(text))
        return " ".join(text.split()).strip().lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _WORD_PAT.findall(self.clean(text)):
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._merge_word(mapped).split())
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytes(self._byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = 77,
                 truncate: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"text {row} tokenizes to {len(ids)} > "
                        f"{context_length} tokens")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[row, : len(ids)] = ids
        return out
