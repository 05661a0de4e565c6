"""A reader of HuggingFace `tokenizer.json` files on the standard library
(the card machine has neither `tokenizers` nor `regex`).

It runs what `tokenizers.Tokenizer.encode(text, add_special_tokens=False)`
and `.decode(ids, skip_special_tokens=True)` run for BPE and WordPiece
tokenizers:

- added tokens are split out of the text first (leftmost-longest, with
  `single_word`, `lstrip` and `rstrip`), the raw-text ones before the
  normalizer and the `normalized` ones after it, so a chat template's
  `<|eot_id|>` is one id;
- normalizers `Replace`, `Prepend`, `NFC`, `BertNormalizer`
  (`clean_text`, `handle_chinese_chars`, `strip_accents`, `lowercase`),
  `Sequence`;
- pre-tokenizers `Split` (regex or string, every `behavior`, `invert`),
  `ByteLevel` (GPT-2's bytes_to_unicode, `add_prefix_space`,
  `use_regex`), `Metaspace`, `BertPreTokenizer`, `Sequence`;
- the BPE model (`merges` as "a b" strings or ["a", "b"] pairs,
  `ignore_merges`, `byte_fallback`, `unk_token`, `fuse_unk`), its result
  cached per pre-token; the WordPiece model (greedy longest match first,
  `continuing_subword_prefix`, `unk_token`, `max_input_chars_per_word`);
- decoders `ByteLevel`, `Replace`, `ByteFallback`, `Fuse`, `Strip`,
  `WordPiece` (`prefix`, `cleanup`), `Sequence`.

Any other component type, a BPE dropout, subword prefix or word suffix,
or a truncation or padding setting raises NotImplementedError naming it: nothing is tokenized with a
component this reader does not run.  The post-processor is not applied
because encoding never adds special tokens (as the JAX tokenizer calls
it).

The regexes of tokenizer.json are Oniguruma's.  Python's `re` has no
`\\p{..}` classes and its `\\s` differs from Oniguruma's, so
`translate_regex` rewrites those into explicit classes built from
`unicodedata` (a letter is a code point of category L*, a number one of
N*, whitespace the Unicode White_Space set).  The BERT components'
character classes (control, punctuation, nonspacing mark) come from
`unicodedata` too; tokenizers takes them from an older Unicode table, so
a code point assigned since may be classed differently.
"""

from __future__ import annotations

import functools
import heapq
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------- regexes

# the Unicode White_Space property (Oniguruma's \s)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
_MAX_CP = 0x10FFFF


@functools.lru_cache(maxsize=1)
def _category_runs() -> Tuple[Tuple[int, int, str], ...]:
    """(first, last, general category) runs over every code point."""
    runs = []
    start, cat = 0, unicodedata.category("\0")
    for cp in range(1, _MAX_CP + 1):
        c = unicodedata.category(chr(cp))
        if c != cat:
            runs.append((start, cp - 1, cat))
            start, cat = cp, c
    runs.append((start, _MAX_CP, cat))
    return tuple(runs)


def _merge_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    out: List[List[int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return tuple((lo, hi) for lo, hi in out)


@functools.lru_cache(maxsize=None)
def _category_ranges(prefixes: Tuple[str, ...]) -> Tuple[Tuple[int, int], ...]:
    """Code point ranges whose general category starts with a prefix."""
    return _merge_ranges((lo, hi) for lo, hi, cat in _category_runs()
                         if cat.startswith(prefixes))


def _complement(ranges) -> Tuple[Tuple[int, int], ...]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= _MAX_CP:
        out.append((nxt, _MAX_CP))
    return tuple(out)


def _class_body(ranges) -> str:
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in ranges)


def _property_ranges(name: str) -> Tuple[Tuple[int, int], ...]:
    """\\p{X}: a general category (Lu) or its group (L)."""
    if len(name) in (1, 2) and name[0] in "LMNPSZC" and (
            len(name) == 1 or name[1].islower()):
        return _category_ranges((name,))
    raise NotImplementedError(f"regex property \\p{{{name}}} is not supported")


def _escape_ranges(letter: str) -> Tuple[Tuple[int, int], ...]:
    """Oniguruma's Unicode classes for \\s and \\d (and complements).
    Its \\w follows the Alphabetic property, which unicodedata does not
    give, so \\w and \\W are refused."""
    r = (_merge_ranges(_WHITE_SPACE) if letter.lower() == "s"
         else _category_ranges(("Nd",)))
    return _complement(r) if letter.isupper() else r


@functools.lru_cache(maxsize=64)
def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json as an equivalent Python
    `re` pattern: \\p{X} / \\P{X} / \\pX, \\s \\S \\d \\D become explicit
    code point classes; other escapes and the syntax the two engines
    share pass through.  Raises
    NotImplementedError on what it cannot carry over (nested classes,
    backreferences, \\w and \\b, an unknown escape).  The classes follow
    Python's unicodedata, whose Unicode version may be older than
    Oniguruma's: code points assigned since are outside every class."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    class_start = -1  # index of the first character inside the class

    def emit(ranges, negate=False):
        if in_class:
            out.append(_class_body(_complement(ranges) if negate else ranges))
        else:
            out.append(("[^" if negate else "[") + _class_body(ranges) + "]")

    while i < n:
        ch = pattern[i]
        if ch == "\\":
            if i + 1 >= n:
                raise NotImplementedError(f"regex ends in a backslash: {pattern!r}")
            nx = pattern[i + 1]
            if nx in "pP":
                negate = nx == "P"
                if i + 2 < n and pattern[i + 2] == "{":
                    end = pattern.index("}", i + 3)
                    name = pattern[i + 3:end]
                    i = end + 1
                else:
                    name = pattern[i + 2]
                    i += 3
                if name.startswith("^"):
                    negate, name = not negate, name[1:]
                emit(_property_ranges(name), negate)
                continue
            if nx in "sSdD":
                emit(_escape_ranges(nx))
                i += 2
                continue
            if nx == "x" and pattern.startswith("{", i + 2):
                raise NotImplementedError(f"regex escape \\x{{..}} in {pattern!r}")
            if nx.isdigit() and nx != "0" or nx in "wWhHkgGzZbBAKRXyYNO":
                raise NotImplementedError(
                    f"regex escape \\{nx} is not supported: {pattern!r}")
            if nx.isalpha() and nx not in "rntfvaxu":
                raise NotImplementedError(
                    f"regex escape \\{nx} is not supported: {pattern!r}")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class:
            if ch == "[":
                raise NotImplementedError(f"nested regex class in {pattern!r}")
            if ch == "&" and pattern.startswith("&&", i):
                raise NotImplementedError(f"regex class intersection in {pattern!r}")
            if ch == "]" and i > class_start:
                in_class = False
        elif ch == "[":
            in_class = True
            class_start = i + 1
            if pattern.startswith("[^", i):
                class_start += 1
                out.append("[^")
                i += 2
                continue
        out.append(ch)
        i += 1
    if in_class:
        raise NotImplementedError(f"unterminated regex class in {pattern!r}")
    return "".join(out)


def _pattern_regex(pattern: dict) -> "re.Pattern":
    """A tokenizer.json {"String": s} or {"Regex": r} pattern, compiled."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        return re.compile(translate_regex(pattern["Regex"]))
    raise NotImplementedError(f"pattern {pattern!r} is not supported")


def _find_matches(regex: "re.Pattern", text: str) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) spans covering `text` (tokenizers'
    Pattern::find_matches)."""
    if not text:
        return [(0, 0, False)]
    out, prev = [], 0
    for m in regex.finditer(text):
        if m.start() != prev:
            out.append((prev, m.start(), False))
        out.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split(text: str, spans, behavior: str) -> List[Tuple[int, str]]:
    """(start, piece) of `text` per tokenizers' SplitDelimiterBehavior,
    empty pieces dropped."""
    if behavior == "Removed":
        return [(a, text[a:b]) for a, b, m in spans if not m and b > a]
    if behavior == "Isolated":
        return [(a, text[a:b]) for a, b, _ in spans if b > a]
    merged: List[List[int]] = []
    prev_match = False
    if behavior == "MergedWithPrevious":
        for a, b, m in spans:
            if m and not prev_match and merged:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            prev_match = m
    elif behavior == "MergedWithNext":
        for a, b, m in reversed(spans):
            if m and not prev_match and merged:
                merged[-1][0] = a
            else:
                merged.append([a, b])
            prev_match = m
        merged.reverse()
    elif behavior == "Contiguous":
        for a, b, m in spans:
            if m == prev_match and merged:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            prev_match = m
    else:
        raise NotImplementedError(f"split behavior {behavior!r} is not supported")
    return [(a, text[a:b]) for a, b in merged if b > a]


# ---------------------------------------------------------------- byte level


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
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


@functools.lru_cache(maxsize=1)
def _byte_level_table() -> Dict[int, str]:
    """str.translate table from latin-1 characters (one per byte) to the
    byte-level characters."""
    return {b: c for b, c in bytes_to_unicode().items()}


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _byte_level(text: str) -> str:
    return text.encode("utf-8").decode("latin-1").translate(_byte_level_table())


# GPT-2's pre-tokenization regex (ByteLevel use_regex=True)
_GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
               r"|\s+(?!\S)|\s+")

# ---------------------------------------------------------------- components
# A piece in flight is (text, at_start): at_start marks the piece that
# begins at offset 0 of the input (Metaspace's prepend_scheme "first").


def _normalizer(cfg: Optional[dict]):
    """str -> str of a tokenizer.json normalizer (None: identity)."""
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        steps = [_normalizer(c) for c in cfg["normalizers"]]
        steps = [s for s in steps if s is not None]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text
        return run
    if kind == "Replace":
        regex = _pattern_regex(cfg["pattern"])
        content = cfg["content"]
        return lambda text: regex.sub(lambda _m: content, text)
    if kind == "Prepend":
        prepend = cfg["prepend"]
        return lambda text: prepend + text if text else text
    if kind == "NFC":
        return lambda text: unicodedata.normalize("NFC", text)
    if kind == "BertNormalizer":
        return functools.partial(
            _bert_normalize, clean_text=bool(cfg.get("clean_text", True)),
            chinese=bool(cfg.get("handle_chinese_chars", True)),
            strip_accents=cfg.get("strip_accents"),
            lowercase=bool(cfg.get("lowercase", True)))
    raise NotImplementedError(f"normalizer {kind!r} is not supported")


# ---------------------------------------------------------------- BERT
# tokenizers' normalizers/bert.rs and pre_tokenizers/bert.rs

# CJK ideograph blocks that BertNormalizer isolates with spaces
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _bert_whitespace(c: str) -> bool:
    return c in "\t\n\r" or _is_white_space(c)


def _bert_control(c: str) -> bool:
    """Categories C* (Cc, Cf, Cn, Co, Cs) except tab, newline and return."""
    return c not in "\t\n\r" and unicodedata.category(c)[0] == "C"


def _bert_punctuation(c: str) -> bool:
    """ASCII punctuation (symbols such as $ + < = > ^ ` | ~ included) or a
    code point of category P*."""
    return (c.isascii() and not c.isalnum() and 0x21 <= ord(c) <= 0x7E) or (
        unicodedata.category(c)[0] == "P")


def _bert_normalize(text: str, clean_text: bool, chinese: bool,
                    strip_accents: Optional[bool], lowercase: bool) -> str:
    if clean_text:
        text = "".join(" " if _bert_whitespace(c) else c for c in text
                       if c not in "\0\ufffd" and not _bert_control(c))
    if chinese:
        text = "".join(f" {c} " if any(lo <= ord(c) <= hi for lo, hi in _CJK) else c
                       for c in text)
    if lowercase if strip_accents is None else strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if lowercase:
        # char by char, as tokenizers lowercases (no final-sigma rule)
        text = "".join(c.lower() for c in text)
    return text


def _bert_pre_tokenize(pieces):
    """Split on whitespace (dropped), then isolate every punctuation
    character."""
    out = []
    for text, at_start in pieces:
        word, start = [], 0
        for i, c in enumerate(text):
            if _is_white_space(c) or _bert_punctuation(c):
                if word:
                    out.append(("".join(word), at_start and start == 0))
                    word = []
                if not _is_white_space(c):
                    out.append((c, at_start and i == 0))
                start = i + 1
            else:
                word.append(c)
        if word:
            out.append(("".join(word), at_start and start == 0))
    return out


def _pre_tokenizer(cfg: Optional[dict]):
    """[(text, at_start)] -> [(text, at_start)] of a tokenizer.json
    pre-tokenizer (None: identity)."""
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(c) for c in cfg["pretokenizers"]]
        steps = [s for s in steps if s is not None]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "Split":
        regex = _pattern_regex(cfg["pattern"])
        behavior, invert = cfg["behavior"], bool(cfg.get("invert", False))

        def split(pieces):
            out = []
            for text, at_start in pieces:
                spans = _find_matches(regex, text)
                if invert:
                    spans = [(a, b, not m) for a, b, m in spans]
                out.extend((sub, at_start and a == 0)
                           for a, sub in _split(text, spans, behavior))
            return out
        _split(".", [(0, 1, True)], behavior)  # validate the behavior now
        return split
    if kind == "ByteLevel":
        prefix = bool(cfg.get("add_prefix_space", True))
        regex = (re.compile(translate_regex(_GPT2_SPLIT))
                 if cfg.get("use_regex", True) else None)

        def byte_level(pieces):
            out = []
            for text, at_start in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                subs = (_split(text, _find_matches(regex, text), "Isolated")
                        if regex is not None else [(0, text)])
                out.extend((_byte_level(sub), at_start and a == 0)
                           for a, sub in subs)
            return out
        return byte_level
    if kind == "Metaspace":
        repl = cfg.get("replacement", "▁")
        scheme = cfg.get("prepend_scheme")
        if scheme is None:  # tokenizers < 0.19 wrote add_prefix_space
            scheme = "always" if cfg.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
        do_split = bool(cfg.get("split", True))
        regex = re.compile(re.escape(repl))

        def metaspace(pieces):
            out = []
            for text, at_start in pieces:
                text = text.replace(" ", repl)
                if text and not text.startswith(repl) and (
                        scheme == "always" or (scheme == "first" and at_start)):
                    text = repl + text
                subs = (_split(text, _find_matches(regex, text), "MergedWithNext")
                        if do_split else [(0, text)] if text else [])
                out.extend((sub, at_start and a == 0) for a, sub in subs)
            return out
        return metaspace
    if kind == "BertPreTokenizer":
        return _bert_pre_tokenize
    raise NotImplementedError(f"pre-tokenizer {kind!r} is not supported")


def _decoder(cfg: Optional[dict]):
    """[token str] -> [str] (a decoder's decode_chain); None: the tokens
    are joined with spaces."""
    if cfg is None:
        return None
    kind = cfg.get("type")
    if kind == "Sequence":
        steps = [_decoder(c) for c in cfg["decoders"]]

        def run(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return run
    if kind == "ByteLevel":
        table = _unicode_to_bytes()

        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                if all(c in table for c in t):
                    data.extend(table[c] for c in t)
                else:
                    data.extend(t.encode("utf-8"))
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        regex = _pattern_regex(cfg["pattern"])
        content = cfg["content"]
        return lambda tokens: [regex.sub(lambda _m: content, t) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens):
            out: List[str] = []
            pending = bytearray()

            def flush():
                try:
                    out.append(pending.decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in pending)
                pending.clear()

            for t in tokens:
                if (len(t) == 6 and t.startswith("<0x") and t.endswith(">")
                        and all(c in "0123456789abcdefABCDEF" for c in t[3:5])):
                    pending.append(int(t[3:5], 16))
                    continue
                if pending:
                    flush()
                out.append(t)
            if pending:
                flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content = cfg["content"]
        start, stop = int(cfg.get("start", 0)), int(cfg.get("stop", 0))

        def strip(tokens):
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for _ in range(stop):
                    if b > a and t[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(t[a:b])
            return out
        return strip
    if kind == "WordPiece":
        prefix = cfg.get("prefix", "##")
        cleanup = bool(cfg.get("cleanup", True))

        def wordpiece(tokens):
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
                out.append(_cleanup(t) if cleanup else t)
            return out
        return wordpiece
    raise NotImplementedError(f"decoder {kind!r} is not supported")


_CLEANUP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
            (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
            (" 've", "'ve"), (" 're", "'re"))


def _cleanup(text: str) -> str:
    """tokenizers' decoders::wordpiece::cleanup."""
    for a, b in _CLEANUP:
        text = text.replace(a, b)
    return text


# ---------------------------------------------------------------- BPE model


class BPE:
    """The BPE model of a tokenizer.json ("model": {"type": "BPE", ...}):
    pre-token -> ids, as tokenizers' BPE::tokenize does it (merges by
    rank, the leftmost first among equal ranks), cached per pre-token."""

    CACHE_LIMIT = 1 << 16

    def __init__(self, cfg: dict):
        if cfg.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"model {cfg.get('type')!r} is not supported")
        if cfg.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError("BPE dropout is not supported")
        self.vocab: Dict[str, int] = dict(cfg["vocab"])
        self.unk_token: Optional[str] = cfg.get("unk_token")
        self.fuse_unk = bool(cfg.get("fuse_unk", False))
        self.byte_fallback = bool(cfg.get("byte_fallback", False))
        self.ignore_merges = bool(cfg.get("ignore_merges", False))
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if cfg.get(key):
                raise NotImplementedError(f"BPE {key} is not supported")
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(cfg.get("merges") or []):
            if isinstance(merge, str):
                parts = merge.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"malformed BPE merge {merge!r}")
                a, b = parts
            else:
                a, b = merge
            try:
                pair = (self.vocab[a], self.vocab[b])
                new_id = self.vocab[a + b]
            except KeyError as e:
                raise ValueError(f"BPE merge {merge!r} names a token outside "
                                 f"the vocabulary: {e}") from None
            self.merges[pair] = (rank, new_id)
        self._cache: Dict[str, List[int]] = {}

    def tokenize(self, piece: str) -> List[int]:
        if not piece:
            return []
        if self.ignore_merges:
            tid = self.vocab.get(piece)
            if tid is not None:
                return [tid]
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        ids = self._merge_all(self._symbols(piece))
        if len(self._cache) >= self.CACHE_LIMIT:
            self._cache.clear()
        self._cache[piece] = ids
        return ids

    def _symbols(self, piece: str) -> List[int]:
        """The piece's characters as ids: byte-fallback tokens or the unk
        token for those outside the vocabulary (tokenizers' merge_word,
        including where a pending unk lands after byte-fallback ids)."""
        ids: List[int] = []
        unk: Optional[int] = None
        for ch in piece:
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                fb = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(t is not None for t in fb):
                    ids.extend(fb)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(
                        f"unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = unk_id
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, ids: List[int]) -> List[int]:
        n = len(ids)
        if n < 2:
            return ids
        merges = self.merges
        sym = list(ids)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new = heapq.heappop(heap)
            if not alive[pos]:
                continue
            j = nxt[pos]
            if j == -1:
                continue
            m = merges.get((sym[pos], sym[j]))
            if m is None or m[1] != new:
                continue  # a stale entry
            sym[pos] = new
            alive[j] = False
            nj = nxt[j]
            nxt[pos] = nj
            if nj != -1:
                prev[nj] = pos
            p = prev[pos]
            if p >= 0:
                m = merges.get((sym[p], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nj != -1:
                m = merges.get((new, sym[nj]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [sym[i] for i in range(n) if alive[i]]


# ---------------------------------------------------------------- WordPiece


class WordPiece:
    """The WordPiece model of a tokenizer.json ("model": {"type":
    "WordPiece", ...}): pre-token -> ids by greedy longest match first,
    every piece after the first looked up with the continuation prefix; a
    word with a part no piece matches, or longer than
    max_input_chars_per_word characters, is the unk token alone
    (tokenizers' WordPiece::tokenize)."""

    def __init__(self, cfg: dict):
        self.vocab: Dict[str, int] = dict(cfg["vocab"])
        self.unk_token: str = cfg.get("unk_token", "[UNK]")
        self.prefix: str = cfg.get("continuing_subword_prefix", "##")
        self.max_chars = int(cfg.get("max_input_chars_per_word", 100))

    def _unk(self) -> List[int]:
        tid = self.vocab.get(self.unk_token)
        if tid is None:
            raise ValueError(f"unk_token {self.unk_token!r} is not in the vocabulary")
        return [tid]

    def tokenize(self, piece: str) -> List[int]:
        if len(piece) > self.max_chars:
            return self._unk()
        ids: List[int] = []
        start = 0
        while start < len(piece):
            end = len(piece)
            while start < end:
                sub = piece[start:end]
                tid = self.vocab.get(self.prefix + sub if start else sub)
                if tid is not None:
                    ids.append(tid)
                    break
                end -= 1
            else:
                return self._unk()
            start = end
        return ids


def _model(cfg: dict):
    kind = cfg.get("type", "BPE")
    if kind == "WordPiece":
        return WordPiece(cfg)
    return BPE(cfg)


# ---------------------------------------------------------------- tokenizer


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def _is_white_space(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _WHITE_SPACE)


class AddedTokens:
    """The added tokens of a tokenizer.json, split out of text before the
    model sees it (tokenizers' AddedVocabulary)."""

    def __init__(self, entries: Sequence[dict], normalize):
        self.by_id: Dict[int, str] = {}
        self.ids: Dict[str, int] = {}
        self.special: set = set()
        raw: Dict[str, dict] = {}
        normed: Dict[str, dict] = {}
        for e in entries:
            content, tid = e["content"], int(e["id"])
            self.by_id[tid] = content
            self.ids[content] = tid
            if e.get("special", False):
                self.special.add(content)
            if not content:
                continue
            if e.get("normalized", not e.get("special", False)) and normalize:
                normed[normalize(content)] = e
            else:
                raw[content] = e
        self._raw = self._matcher(raw)
        self._normed = self._matcher(normed)

    @staticmethod
    def _matcher(table: Dict[str, dict]):
        if not table:
            return None
        # longest first: Python's alternation takes the first alternative
        # that matches, so this is leftmost-longest
        alternatives = sorted(table, key=len, reverse=True)
        regex = re.compile("|".join(re.escape(a) for a in alternatives))
        return regex, table

    def split(self, text: str, normalized: bool) -> List[Tuple[int, int, Optional[int]]]:
        """(start, end, added token id or None) spans of `text`."""
        matcher = self._normed if normalized else self._raw
        if matcher is None:
            return [(0, len(text), None)] if text else []
        regex, table = matcher
        out: List[Tuple[int, int, Optional[int]]] = []
        last = 0
        for m in regex.finditer(text):
            start, stop = m.span()
            entry = table[m.group()]
            if entry.get("single_word", False):
                if ((start > 0 and _is_word_char(text[start - 1]))
                        or (stop < len(text) and _is_word_char(text[stop]))):
                    continue
            if entry.get("lstrip", False):
                while start > 0 and _is_white_space(text[start - 1]):
                    start -= 1
                start = max(start, last)
            if entry.get("rstrip", False):
                while stop < len(text) and _is_white_space(text[stop]):
                    stop += 1
            if last < start:
                out.append((last, start, None))
            out.append((start, stop, int(entry["id"])))
            last = stop
        if last != len(text):
            out.append((last, len(text), None))
        return out


class TokenizerJSON:
    """encode / decode / token_to_id / vocab size of one tokenizer.json
    (a dict, as json.load gives it)."""

    def __init__(self, data: dict):
        for key in ("truncation", "padding"):
            if data.get(key) is not None:
                raise NotImplementedError(f"tokenizer.json {key} is not supported")
        self.model = _model(data["model"])
        self._normalize = _normalizer(data.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(data.get("pre_tokenizer"))
        self._decode_chain = _decoder(data.get("decoder"))
        self.added = AddedTokens(data.get("added_tokens") or [], self._normalize)
        self._id_to_token = {i: t for t, i in self.model.vocab.items()}

    def get_vocab_size(self) -> int:
        """Model vocabulary and added tokens, each distinct string once."""
        return len(self.model.vocab.keys() | self.added.ids.keys())

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.ids.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for a, b, tid in self.added.split(text, normalized=False):
            if tid is not None:
                ids.append(tid)
                continue
            piece = text[a:b]
            if self._normalize is not None:
                piece = self._normalize(piece)
            for c, d, tid2 in self.added.split(piece, normalized=True):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                pieces = [(piece[c:d], a == 0 and c == 0)]
                if self._pre_tokenize is not None:
                    pieces = self._pre_tokenize(pieces)
                for p, _ in pieces:
                    ids.extend(self.model.tokenize(p))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self.added.by_id.get(int(i))
            if t is None:
                t = self._id_to_token.get(int(i))
            if t is None or (skip_special_tokens and t in self.added.special):
                continue
            tokens.append(t)
        if self._decode_chain is None:
            return " ".join(tokens)
        return "".join(self._decode_chain(tokens))
