"""CLIP's byte-level BPE tokenizer, without `transformers`, `regex` or `ftfy`.

The ids are those of `transformers.CLIPTokenizer` (the slow tokenizer) on a
machine without `ftfy`, the path the JAX package's `data/text.py` runs: the
text is cleaned by BERT's BasicTokenizer with `strip_accents=False` and
`do_split_on_punc=False` (control characters, U+0000 and U+FFFD dropped,
white space made one space, a space around each CJK ideograph, NFC, lower
case), split by CLIP's pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

(case-insensitive), each piece's UTF-8 bytes mapped to printable characters
(`bytes_to_unicode`) and merged by the ranks of `merges.txt`. The standard
`re` module has no `\\p{..}`, so `split_words` scans the text by
`unicodedata.category`: L* is a letter, Nd/Nl/No a number. U+0345 (a
combining mark whose case fold is a letter) matches none of the pattern's
classes under IGNORECASE and is dropped, as the `regex` module drops it.
Letters and numbers assigned after the Unicode version of Python's
`unicodedata` are not letters or numbers here.

With `ftfy` installed, `CLIPTokenizer` runs `ftfy.fix_text` and a plain
white-space clean instead of the BasicTokenizer; that path is not copied. The
two differ on mojibake (text decoded with the wrong codec) and on what ftfy
normalises (e.g. the BasicTokenizer keeps a mark it cannot compose).

Added tokens (`<|startoftext|>`, `<|endoftext|>` and those of
`tokenizer_config.json`'s `added_tokens_decoder` or `added_tokens.json`) are
split out of the text first, leftmost and then longest, with their
lstrip / rstrip flags, and map to their ids (a single_word token raises).
"""

from __future__ import annotations

import json
import unicodedata
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# `merges.txt` lines transformers reads: after the version line, at most
# 49152 - 256 - 2 merges (`tokenization_clip.py`'s slice)
MAX_MERGES = 49152 - 256 - 2
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# what a character of the pattern's literals matches under the `regex`
# module's IGNORECASE (simple case folding): its two cases, and U+017F for s
_FOLD = {c: {c, c.upper()} | ({"ſ"} if c == "s" else set()) for c in "abcdefghijklmnopqrstuvwxyz"}


@lru_cache
def bytes_to_unicode() -> Dict[int, str]:
    """Byte -> printable character: the printable Latin-1 bytes map to
    themselves, the rest to U+0100 onwards, in byte order."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """BERT's BasicTokenizer as CLIPTokenizer builds it (lower case, no
    accent stripping, no punctuation split), its tokens joined by spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out += [" ", ch, " "]
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _char_class(ch: str) -> str:
    if ch.isspace():
        return " "
    if ch == "ͅ":
        return ""
    cat = unicodedata.category(ch)
    return cat[0] if cat[0] in "LN" else "P"


def _match_literal(text: str, i: int, lit: str) -> bool:
    if i + len(lit) > len(text):
        return False
    return all(t == c or (c in _FOLD and t in _FOLD[c]) for t, c in zip(text[i:i + len(lit)], lit))


def split_words(text: str) -> List[str]:
    """`regex.findall` of CLIP's pattern, IGNORECASE, on cleaned text."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((w for w in (BOS, EOS) + _CONTRACTIONS if _match_literal(text, i, w)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _char_class(text[i])
        if kind in ("L", "P"):  # a run of letters, or of what is neither space, letter nor number
            j = i + 1
            while j < n and _char_class(text[j]) == kind:
                j += 1
            out.append(text[i:j])
            i = j
        elif kind == "N":  # one number a piece
            out.append(text[i])
            i += 1
        else:  # space, or U+0345: matched by no alternative
            i += 1
    return out


def _pairs(word: Tuple[str, ...]):
    return set(zip(word, word[1:]))


def _token_field(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


class CLIPTokenizer:
    """`transformers.CLIPTokenizer` (slow, no ftfy): `encoder` maps a BPE
    token to its id, `merges` are the ranked pairs."""

    def __init__(self, encoder: Dict[str, int], merges: Sequence[Tuple[str, str]], bos_token: str = BOS,
                 eos_token: str = EOS, unk_token: str = EOS, pad_token: str = EOS,
                 added_tokens: Optional[Dict[str, dict]] = None):
        self.encoder = dict(encoder)
        self.bpe_ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {BOS: BOS, EOS: EOS}
        # the special tokens are added tokens too (PreTrainedTokenizer's init), with no strip flags
        self.added: Dict[str, dict] = {t: {"id": self.encoder[t]} for t in (bos_token, eos_token, unk_token, pad_token)
                                       if t in self.encoder}
        self.added.update(added_tokens or {})
        self.unk_id = self.added[unk_token]["id"] if unk_token in self.added else self.encoder.get(unk_token)
        self.bos_token_id, self.eos_token_id = self.token_id(bos_token), self.token_id(eos_token)
        self.pad_token_id = self.token_id(pad_token)

    @classmethod
    def from_pretrained(cls, path: Union[str, Path]) -> "CLIPTokenizer":
        """A transformers tokenizer directory: `vocab.json`, `merges.txt`,
        and where present `tokenizer_config.json`, `special_tokens_map.json`
        and `added_tokens.json`."""
        d = Path(path)
        if not (d / "vocab.json").is_file() or not (d / "merges.txt").is_file():
            raise FileNotFoundError(f"{d}: a CLIP tokenizer needs vocab.json and merges.txt")
        encoder = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        lines = (d / "merges.txt").read_text(encoding="utf-8").strip().split("\n")[1:MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        conf = json.loads((d / "tokenizer_config.json").read_text(encoding="utf-8")) \
            if (d / "tokenizer_config.json").is_file() else {}
        if (d / "special_tokens_map.json").is_file():
            conf.update(json.loads((d / "special_tokens_map.json").read_text(encoding="utf-8")))
        added = {}
        for i, tok in (conf.get("added_tokens_decoder") or {}).items():
            if tok.get("single_word"):
                raise NotImplementedError(f"{d}: added token {tok['content']!r} is single_word")
            added[tok["content"]] = {"id": int(i), "lstrip": bool(tok.get("lstrip")), "rstrip": bool(tok.get("rstrip"))}
        if (d / "added_tokens.json").is_file():
            for tok, i in json.loads((d / "added_tokens.json").read_text(encoding="utf-8")).items():
                added.setdefault(tok, {"id": int(i)})
        specials = {k: _token_field(conf.get(k)) or default for k, default in
                    (("bos_token", BOS), ("eos_token", EOS), ("unk_token", EOS), ("pad_token", EOS))}
        return cls(encoder, merges, added_tokens=added, **specials)

    def token_id(self, token: str) -> int:
        """An added token's id, else the vocabulary's, else the unknown token's."""
        if token in self.added:
            return self.added[token]["id"]
        return self.encoder.get(token, self.unk_id)

    def bpe(self, token: str) -> str:
        """The merged symbols of one byte-mapped word, space separated."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _split_added(self, text: str) -> List[str]:
        """The text cut around its added tokens, leftmost first, longest at a
        start; the strip flags applied to the neighbouring pieces."""
        pieces, start, i = [], 0, 0
        while i < len(text):
            hit = max((t for t in self.added if text.startswith(t, i)), key=len, default=None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i = start = i + len(hit)
        pieces.append(text[start:])
        for k, piece in enumerate(pieces):
            if k % 2 == 0:
                continue
            flags = self.added[piece]
            if flags.get("rstrip"):
                pieces[k + 1] = pieces[k + 1].lstrip()
            if flags.get("lstrip"):
                pieces[k - 1] = pieces[k - 1].rstrip()
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        for k, piece in enumerate(self._split_added(text)):
            if not piece:
                continue
            if k % 2 == 1:
                tokens.append(piece)
                continue
            for word in split_words(basic_clean(piece)):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                tokens += self.bpe(mapped).split(" ")
        return tokens

    def encode(self, text: str) -> List[int]:
        """The ids of one text, without the start and end tokens."""
        return [self.token_id(t) for t in self.tokenize(text)]

    def __call__(self, texts: Union[str, Sequence[str]], padding: Union[bool, str] = True,
                 max_length: Optional[int] = None, truncation: bool = False) -> Dict[str, torch.Tensor]:
        """{"input_ids", "attention_mask"}: (K, T) int64 tensors, each row
        start + ids + end, padded on the right with the pad token (mask 0).
        padding=True (or "longest") pads to the longest row; "max_length"
        to `max_length`. truncation=True cuts each row's ids so it fits
        `max_length`."""
        texts = [texts] if isinstance(texts, str) else list(texts)
        if padding not in (True, "longest", "max_length"):
            raise ValueError(f"padding={padding!r}: take True, 'longest' or 'max_length'")
        if max_length is None and (truncation or padding == "max_length"):
            raise ValueError("truncation and padding='max_length' take a max_length")
        rows = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                if max_length < 2:
                    raise ValueError(f"max_length={max_length} leaves no room for the start and end tokens")
                ids = ids[:max_length - 2]
            rows.append([self.bos_token_id] + ids + [self.eos_token_id])
        width = max_length if padding == "max_length" else max((len(r) for r in rows), default=0)
        if any(len(r) > width for r in rows):
            raise ValueError(f"a text of {max(len(r) for r in rows)} tokens is longer than max_length={width}: "
                             f"pass truncation=True")
        ids = torch.full((len(rows), width), self.pad_token_id, dtype=torch.int64)
        mask = torch.zeros((len(rows), width), dtype=torch.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = torch.tensor(r, dtype=torch.int64)
            mask[i, :len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def train_byte_bpe(corpus: Iterable[str], n_merges: int,
                   special_ids: Optional[Tuple[int, int]] = None) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A byte-level BPE vocabulary in CLIP's layout, learnt from `corpus`
    (for tests and smoke runs, where no real vocabulary is at hand): the 256
    byte characters, the same with "</w>", one token a merge (most frequent
    pair first, ties by the pair's order), then <|startoftext|> and
    <|endoftext|> (at `special_ids` when given, else next). Returns
    (encoder, merges)."""
    byte_encoder = bytes_to_unicode()
    words = Counter()
    for text in corpus:
        for w in split_words(basic_clean(text)):
            mapped = "".join(byte_encoder[b] for b in w.encode("utf-8"))
            words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    vocab = list(byte_encoder.values())
    vocab += [v + "</w>" for v in vocab]
    merges: List[Tuple[str, str]] = []
    while len(merges) < n_merges:
        counts = Counter()
        for word, c in words.items():
            for p in zip(word, word[1:]):
                counts[p] += c
        if not counts:
            break
        best = min(counts, key=lambda p: (-counts[p], p))
        merges.append(best)
        vocab.append(best[0] + best[1])
        merged = Counter()
        for word, c in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    encoder: Dict[str, int] = {}
    for tok in vocab:
        encoder.setdefault(tok, len(encoder))
    bos, eos = special_ids if special_ids is not None else (len(encoder), len(encoder) + 1)
    encoder[BOS], encoder[EOS] = bos, eos
    return encoder, merges


def write_vocab(path: Union[str, Path], encoder: Dict[str, int], merges: Sequence[Tuple[str, str]]) -> None:
    """`vocab.json` and `merges.txt` in the layout transformers reads."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(encoder, ensure_ascii=False), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
