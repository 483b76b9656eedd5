"""A reader of the HuggingFace ``tokenizers``-library ``tokenizer.json``, in
pure Python.

The JAX package's ``HFTokenizer`` (``kubeflow_tpu/serving/engine/serve.py``)
wraps the ``tokenizers`` library.  The port reads the same file itself, so
it needs neither that library nor ``regex``: ``HFTokenizer(data).encode``
gives the library's ``encode(text).ids`` (special tokens added), ``decode``
its ``decode(ids, skip_special_tokens=True)``, and ``vocab_size`` its
``get_vocab_size()`` (added tokens counted).

It covers the components of the checkouts ``hf_convert`` converts:

* models: ``BPE`` (merges by rank, ``ignore_merges``, ``byte_fallback`` with
  ``<0xNN>`` tokens, ``unk_token`` / ``fuse_unk``, the subword prefix and
  suffix) and ``WordLevel``;
* normalizers: ``Sequence``, ``Prepend``, ``Replace``;
* pre-tokenizers: ``Sequence``, ``Split`` (string or regex pattern; the
  ``Isolated``, ``Removed``, ``MergedWithPrevious`` (Gemma's) and
  ``MergedWithNext`` behaviours; ``invert``),
  ``ByteLevel`` (with or without its GPT-2 regex), ``Metaspace``,
  ``Whitespace``;
* post-processors: ``TemplateProcessing`` (single sequence), ``ByteLevel``
  (ids unchanged), ``Sequence``;
* decoders: ``ByteLevel``, ``Replace``, ``ByteFallback``, ``Fuse``,
  ``Strip``, ``Metaspace``, ``Sequence``, and none (tokens joined by a
  space);
* added tokens, special or not, split out of the raw text before
  normalization (``normalized: false``) or out of the normalized text
  (``normalized: true``), with ``lstrip``, ``rstrip`` and ``single_word``.

Any other component, a ``truncation`` or ``padding`` block, or BPE dropout
raises ``ValueError`` naming it: a file this reader cannot encode as the
library does is refused, never mis-encoded.

The regex patterns of ``Split`` are Oniguruma's (Llama-3's uses ``\\p{L}``,
``\\p{N}``, ``\\s`` and a ``(?i:...)`` group); they are translated to
Python's ``re`` with the library's own Unicode classes, which
``_unicode_tables.py`` holds as code-point ranges (Python's ``unicodedata``
is an older Unicode version than the library's).

The class exposes no ``inv`` dict: ``constrain.token_bytes_from_tokenizer``
then decodes one id at a time, which gives the library's strings (U+FFFD for
a partial UTF-8 byte token, ``""`` for a special token).
"""

from __future__ import annotations

import heapq
import json
import re
from typing import Optional

from . import _unicode_tables as U

# the White_Space property: \s of both Oniguruma and Rust regex
_WHITE_SPACE = ((0x9, 0xD), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def _class_body(ranges) -> str:
    return "".join(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}"
                   for lo, hi in ranges)


_BODY = {"L": _class_body(U.LETTER), "N": _class_body(U.NUMBER),
         "s": _class_body(_WHITE_SPACE)}
_W = _class_body(U.WORD)
_RUST_WORD_START = re.compile(f"[{_W}]")
_RUST_WS = re.compile(f"[{_BODY['s']}]*")
_RUST_WS_END = re.compile(f"[{_BODY['s']}]*\\Z")
_WHITESPACE_RE = re.compile(f"[{_W}]+|[^{_W}{_BODY['s']}]+")  # the Whitespace pre-tokenizer
# the ByteLevel pre-tokenizer's own regex (GPT-2's), an Oniguruma pattern
_GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                 r"|\s+(?!\S)|\s+")


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern -> the Python ``re`` pattern that matches what
    the library's matches: ``\\p{L}``, ``\\p{N}`` and ``\\s`` (and their
    negations outside a class) become explicit classes of the library's
    code points; other escapes and the syntax both engines share
    (alternation, ``(?i:...)``, look-arounds, counted repeats) pass through.
    An escape whose class would differ between the engines raises."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            nxt = pattern[i + 1:i + 2]
            if nxt in ("p", "P"):
                m = re.match(r"\{(\w+)\}", pattern[i + 2:])
                name = m.group(1) if m else pattern[i + 2:i + 6]
                if not m or name not in ("L", "N"):
                    raise ValueError(f"regex escape \\{nxt}{{{name}}} is not supported "
                                     f"(\\p{{L}}, \\p{{N}})")
                i += 2 + m.end()
                key, neg = name, nxt == "P"
            elif nxt in ("s", "S"):
                i += 2
                key, neg = "s", nxt == "S"
            elif nxt and nxt in "wWdDhHbBRXKGAzZx":
                raise ValueError(f"regex escape \\{nxt} is not supported (its class "
                                 "differs between Oniguruma and Python)")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                if neg:
                    raise ValueError(f"a negated escape inside a class is not "
                                     f"supported: {pattern!r}")
                out.append(_BODY[key])
            else:
                out.append(f"[{'^' if neg else ''}{_BODY[key]}]")
            continue
        if ch == "[":
            if in_class or pattern[i + 1:i + 2] == ":":
                raise ValueError(f"nested or POSIX classes are not supported: {pattern!r}")
            in_class = True
            out.append(ch)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            continue
        if in_class and pattern.startswith("&&", i):
            raise ValueError(f"class intersection is not supported: {pattern!r}")
        if ch == "]" and in_class:
            in_class = False
        out.append(ch)
        i += 1
    return "".join(out)


def _bytes_to_unicode() -> dict:
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


_BYTE_CHAR = _bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}
# str.translate table over a latin-1 view of the UTF-8 bytes
_BYTE_TRANSLATE = {b: _BYTE_CHAR[b] for b in range(256)}


def _byte_level(s: str) -> str:
    return s.encode("utf-8").decode("latin-1").translate(_BYTE_TRANSLATE)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"tokenizer.json: {what} is not supported by this reader")


def _kind(node: dict, where: str, supported: tuple) -> str:
    t = node.get("type") if isinstance(node, dict) else None
    if t not in supported:
        raise ValueError(f"tokenizer.json: {where}.type {t!r} is not supported by "
                         f"this reader (supported: {', '.join(supported)})")
    return t


def _pattern(node: dict, where: str):
    """A ``{"String": s}`` or ``{"Regex": r}`` pattern -> compiled re."""
    pat = node.get("pattern") or {}
    if "String" in pat:
        return re.compile(re.escape(pat["String"])) if pat["String"] else None
    if "Regex" in pat:
        return re.compile(translate_pattern(pat["Regex"]))
    raise ValueError(f"tokenizer.json: {where}.pattern {pat!r} is not supported")


def _find(regex, s: str) -> list:
    """The library's ``find_matches``: ``(start, end, is_match)`` spans
    covering ``s``, matches and the gaps between them."""
    if not s:
        return [(0, 0, False)]
    spans, prev = [], 0
    if regex is not None:
        for m in regex.finditer(s):
            a, b = m.span()
            if prev != a:
                spans.append((prev, a, False))
            spans.append((a, b, True))
            prev = b
    if prev != len(s):
        spans.append((prev, len(s), False))
    return spans


def _split(s: str, spans: list, behavior: str) -> list:
    """Apply a split behaviour to ``_find`` spans -> [(start, end)], empty
    pieces dropped (``NormalizedString::split``)."""
    if behavior == "Removed":
        kept = [(a, b) for a, b, m in spans if not m]
    elif behavior == "Isolated":
        kept = [(a, b) for a, b, _ in spans]
    elif behavior == "MergedWithPrevious":
        kept, prev_match = [], False
        for a, b, m in spans:
            if m and not prev_match and kept:
                kept[-1] = (kept[-1][0], b)
            else:
                kept.append((a, b))
            prev_match = m
    elif behavior == "MergedWithNext":
        kept, prev_match = [], False
        for a, b, m in reversed(spans):
            if m and not prev_match and kept:
                kept[-1] = (a, kept[-1][1])
            else:
                kept.append((a, b))
            prev_match = m
        kept.reverse()
    else:
        raise ValueError(f"tokenizer.json: split behavior {behavior!r} is not supported")
    return [(a, b) for a, b in kept if a != b]


# ------------------------------------------------------------------ pipeline
#
# A piece is ``(text, at_start)``: ``at_start`` says the piece begins at
# offset 0 of the original input, which Metaspace's "first" scheme reads.


def _normalizer(node, where="normalizer"):
    """tokenizer.json normalizer -> fn(str) -> str (None for none)."""
    if node is None:
        return None
    t = _kind(node, where, ("Sequence", "Prepend", "Replace"))
    if t == "Sequence":
        fns = [_normalizer(n, f"{where}.normalizers[{i}]")
               for i, n in enumerate(node.get("normalizers", []))]
        fns = [f for f in fns if f is not None]

        def seq(s):
            for f in fns:
                s = f(s)
            return s
        return seq
    if t == "Prepend":
        pre = node["prepend"]
        return lambda s: pre + s if s else s
    regex, content = _pattern(node, where), node.get("content", "")
    if regex is None:
        return lambda s: s
    return lambda s: regex.sub(lambda m: content, s)


def _pre_tokenizer(node, where="pre_tokenizer"):
    """tokenizer.json pre-tokenizer -> fn(pieces) -> pieces (None for none)."""
    if node is None:
        return None
    t = _kind(node, where, ("Sequence", "Split", "ByteLevel", "Metaspace", "Whitespace"))
    if t == "Sequence":
        fns = [_pre_tokenizer(n, f"{where}.pretokenizers[{i}]")
               for i, n in enumerate(node.get("pretokenizers", []))]
        fns = [f for f in fns if f is not None]

        def seq(pieces):
            for f in fns:
                pieces = f(pieces)
            return pieces
        return seq
    if t in ("Split", "Whitespace"):
        if t == "Split":
            regex, behavior = _pattern(node, where), node.get("behavior", "Isolated")
            invert = bool(node.get("invert", False))
            _need(behavior in ("Isolated", "Removed", "MergedWithPrevious", "MergedWithNext"),
                  f"{where}.behavior {behavior!r}")
        else:  # the library keeps the matches of \w+|[^\w\s]+
            regex, behavior, invert = _WHITESPACE_RE, "Removed", True

        def split(pieces):
            out = []
            for s, at0 in pieces:
                if behavior == "Isolated" and regex is not None:
                    # every match and every gap is its own piece
                    prev = 0
                    for m in regex.finditer(s):
                        a, b = m.span()
                        if prev != a:
                            out.append((s[prev:a], at0 and prev == 0))
                        if a != b:
                            out.append((s[a:b], at0 and a == 0))
                        prev = b
                    if prev != len(s):
                        out.append((s[prev:], at0 and prev == 0))
                    continue
                spans = _find(regex, s)
                if invert:
                    spans = [(a, b, not m) for a, b, m in spans]
                out += [(s[a:b], at0 and a == 0) for a, b in _split(s, spans, behavior)]
            return out
        return split
    if t == "ByteLevel":
        prefix = bool(node.get("add_prefix_space", True))
        regex = re.compile(translate_pattern(_GPT2_PATTERN)) if node.get("use_regex", True) else None

        def byte_level(pieces):
            out = []
            for s, at0 in pieces:
                if prefix and not s.startswith(" "):
                    s = " " + s
                subs = ([(s[a:b], at0 and a == 0) for a, b in _split(s, _find(regex, s), "Isolated")]
                        if regex is not None else [(s, at0)])
                out += [(_byte_level(p), z) for p, z in subs]
            return out
        return byte_level
    rep = node.get("replacement", "▁")
    scheme = node.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if node.get("add_prefix_space", True) else "never"
    _need(scheme in ("always", "first", "never"), f"{where}.prepend_scheme {scheme!r}")
    do_split = bool(node.get("split", True))
    rep_re = re.compile(re.escape(rep))

    def metaspace(pieces):
        out = []
        for s, at0 in pieces:
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (scheme == "always" or (scheme == "first" and at0)):
                s = rep + s
            if do_split:
                out += [(s[a:b], at0 and a == 0)
                        for a, b in _split(s, _find(rep_re, s), "MergedWithNext")]
            else:
                out.append((s, at0))
        return out
    return metaspace


def _decoder(node, where="decoder") -> Optional[list]:
    """tokenizer.json decoder -> a list of fn(tokens) -> tokens (None for
    none: the library then joins tokens with a space)."""
    if node is None:
        return None
    t = _kind(node, where, ("Sequence", "ByteLevel", "Replace", "ByteFallback",
                            "Fuse", "Strip", "Metaspace"))
    if t == "Sequence":
        out = []
        for i, n in enumerate(node.get("decoders", [])):
            out += _decoder(n, f"{where}.decoders[{i}]") or []
        return out
    if t == "ByteLevel":
        return [lambda toks: [_byte_level_bytes(toks).decode("utf-8", "replace")]]
    if t == "Replace":
        regex, content = _pattern(node, where), node.get("content", "")
        if regex is None:
            return []
        return [lambda toks: [regex.sub(lambda m: content, x) for x in toks]]
    if t == "ByteFallback":
        return [_byte_fallback]
    if t == "Fuse":
        return [lambda toks: ["".join(toks)]]
    if t == "Strip":
        content, start, stop = node["content"], int(node.get("start", 0)), int(node.get("stop", 0))
        return [lambda toks: [_strip(x, content, start, stop) for x in toks]]
    rep = node.get("replacement", "▁")
    scheme = node.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if node.get("add_prefix_space", True) else "never"

    def metaspace(toks):
        return ["".join(("" if i == 0 and scheme != "never" else " ") if c == rep else c
                        for c in x) for i, x in enumerate(toks)]
    return [metaspace]


def _token_bytes(tok: str) -> bytes:
    """One token's bytes under the ByteLevel decoder: each character's byte
    when every character is in the alphabet, else the token's UTF-8."""
    try:
        return bytes(_CHAR_BYTE[c] for c in tok)
    except KeyError:
        return tok.encode("utf-8")


def _byte_level_bytes(toks) -> bytes:
    return b"".join(_token_bytes(t) for t in toks)


def _byte_fallback(toks):
    out, pending = [], bytearray()

    def flush():
        if pending:
            try:
                out.append(pending.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(pending))
            pending.clear()
    for t in toks:
        b = _fallback_byte(t)
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _fallback_byte(tok: str) -> Optional[int]:
    """The byte of a ``<0xNN>`` token (Rust's ``u8::from_str_radix`` on its
    two hex characters, the token's length counted in bytes), else None."""
    raw = tok.encode("utf-8")
    if len(raw) != 6 or not raw.startswith(b"<0x") or not raw.endswith(b">"):
        return None
    digits = raw[3:5].decode("ascii", "replace")
    digits = digits[1:] if digits.startswith("+") else digits
    if not digits or any(c not in "0123456789abcdefABCDEF" for c in digits):
        return None
    return int(digits, 16)


def _strip(tok: str, content: str, start: int, stop: int) -> str:
    a = 0
    for i, c in enumerate(tok[:start]):
        if c != content:
            break
        a = i + 1
    b = len(tok)
    for i in range(stop):
        j = len(tok) - i - 1
        if j < 0 or tok[j] != content:
            break
        b = j
    return tok[a:b]


# ------------------------------------------------------------------- models


class _BPE:
    def __init__(self, node: dict):
        _need(not node.get("dropout"), "model.dropout (BPE dropout is random)")
        self.vocab: dict = dict(node.get("vocab") or {})
        self.unk = node.get("unk_token")
        self.prefix = node.get("continuing_subword_prefix") or ""
        self.suffix = node.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(node.get("fuse_unk", False))
        self.byte_fallback = bool(node.get("byte_fallback", False))
        self.ignore_merges = bool(node.get("ignore_merges", False))
        self.merges: dict = {}
        plen = len(self.prefix)
        for rank, m in enumerate(node.get("merges") or []):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            new = a + b[plen:]
            for tok in (a, b, new):
                if tok not in self.vocab:
                    raise ValueError(f"tokenizer.json: merge token {tok!r} is not "
                                     "in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
        self._cache: dict = {}

    def tokenize(self, w: str) -> list:
        if not w:
            return []
        if self.ignore_merges:
            tid = self.vocab.get(w)
            if tid is not None:
                return [tid]
        hit = self._cache.get(w)
        if hit is None:
            hit = self._merge_all(self._symbols(w))
            if len(self._cache) < 10000:
                self._cache[w] = hit
        return list(hit)

    def _symbols(self, w: str) -> list:
        ids, unk, n = [], None, len(w)
        for i, ch in enumerate(w):
            s = ch
            if i > 0 and self.prefix:
                s = self.prefix + s
            if i == n - 1 and self.suffix:
                s = s + self.suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(tid)
                continue
            if self.byte_fallback:
                bt = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in bt:
                    ids.extend(bt)
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise ValueError(f"unk token {self.unk!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return ids

    def _merge_all(self, c: list) -> list:
        """The library's ``Word::merge_all``: the lowest-rank adjacent pair
        merges first (leftmost on a tie), stale queue entries skipped."""
        n = len(c)
        if n < 2:
            return c
        merges = self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos]:
                continue
            q = nxt[pos]
            if q == -1:
                continue
            m = merges.get((c[pos], c[q]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[q] = False
            nq = nxt[q]
            nxt[pos] = nq
            if nq != -1:
                prev[nq] = pos
            p = prev[pos]
            if p != -1:
                m = merges.get((c[p], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if nq != -1:
                m = merges.get((c[pos], c[nq]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


class _WordLevel:
    def __init__(self, node: dict):
        self.vocab: dict = dict(node.get("vocab") or {})
        self.unk = node.get("unk_token", "<unk>")

    def tokenize(self, w: str) -> list:
        tid = self.vocab.get(w)
        if tid is None:
            tid = self.vocab.get(self.unk)
            if tid is None:
                raise ValueError("WordLevel error: Missing [UNK] token from the vocabulary")
        return [tid]


# ----------------------------------------------------------------- tokenizer


class HFTokenizer:
    """A ``tokenizer.json`` of the ``tokenizers`` library, read without it.
    The surface of the JAX package's ``HFTokenizer``: ``encode``, ``decode``
    and ``vocab_size``."""

    def __init__(self, data: str):
        raw = json.loads(data)
        for key in ("truncation", "padding"):
            _need(raw.get(key) is None, f"a {key} block")
        model = raw.get("model") or {}
        t = _kind(model, "model", ("BPE", "WordLevel"))
        self._model = _BPE(model) if t == "BPE" else _WordLevel(model)
        self._normalize = _normalizer(raw.get("normalizer"))
        self._pre = _pre_tokenizer(raw.get("pre_tokenizer"))
        self._template = self._post_processor(raw.get("post_processor"))
        self._decoders = _decoder(raw.get("decoder"))
        self._byte_level_decode = (self._decoders is not None
                                   and raw["decoder"].get("type") == "ByteLevel")

        # added tokens: content -> id; id -> content; the special set
        self._added: dict = {}
        self._added_inv: dict = {}
        self._special: set = set()
        raw_toks, norm_toks = [], []
        for a in raw.get("added_tokens") or []:
            content, tid = a["content"], int(a["id"])
            self._added[content] = tid
            self._added_inv[tid] = content
            if a.get("special"):
                self._special.add(content)
            flags = (bool(a.get("single_word")), bool(a.get("lstrip")), bool(a.get("rstrip")))
            if a.get("normalized", not a.get("special")):
                match = self._normalize(content) if self._normalize else content
                norm_toks.append((match, tid, flags))
            else:
                raw_toks.append((content, tid, flags))
        self._raw_matcher = self._matcher(raw_toks)
        self._norm_matcher = self._matcher(norm_toks)

        self._inv = {i: tok for tok, i in self._model.vocab.items()}
        self.vocab_size = len(set(self._model.vocab) | set(self._added))
        self._tok_bytes: dict = {}

    # -------------------------------------------------------------- setup

    @staticmethod
    def _matcher(toks: list):
        """Added tokens -> (regex, {content: (id, flags)}): the alternation of
        the contents, longest first, finds the leftmost-longest match as the
        library's Aho-Corasick automaton does."""
        toks = [t for t in toks if t[0]]
        if not toks:
            return None
        by = {c: (tid, flags) for c, tid, flags in toks}
        alts = sorted(by, key=len, reverse=True)
        return re.compile("|".join(re.escape(c) for c in alts)), by

    @staticmethod
    def _post_processor(node, where="post_processor"):
        """-> the single-sequence template as a list of ids and ``None`` (the
        sequence), or None when nothing is added."""
        if node is None:
            return None
        t = _kind(node, where, ("TemplateProcessing", "ByteLevel", "Sequence"))
        if t == "ByteLevel":
            return None
        if t == "Sequence":
            out = None
            for i, n in enumerate(node.get("processors", [])):
                tmpl = HFTokenizer._post_processor(n, f"{where}.processors[{i}]")
                if tmpl is not None:
                    _need(out is None, f"{where}: two templates")
                    out = tmpl
            return out
        specials = node.get("special_tokens") or {}
        out = []
        for item in node.get("single") or []:
            if "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                if name not in specials:
                    raise ValueError(f"tokenizer.json: {where} special token {name!r} "
                                     "has no ids")
                out.extend(int(i) for i in specials[name]["ids"])
            elif "Sequence" in item:
                _need(item["Sequence"]["id"] == "A", f"{where}.single sequence "
                      f"{item['Sequence']['id']!r}")
                out.append(None)
            else:
                raise ValueError(f"tokenizer.json: {where}.single item {item!r} "
                                 "is not supported")
        return out

    # ------------------------------------------------------------- encode

    def _extract(self, s: str, matcher) -> list:
        """The library's ``AddedVocabulary::find_matches``: ``(start, end,
        id or None)`` over ``s``, honouring ``single_word``, ``lstrip`` and
        ``rstrip``."""
        if matcher is None or not s:
            return [(0, len(s), None)]
        regex, by = matcher
        out, last = [], 0
        for m in regex.finditer(s):
            start, stop = m.span()
            tid, (single_word, lstrip, rstrip) = by[m.group()]
            if single_word:
                before = start == 0 or not _RUST_WORD_START.fullmatch(s[start - 1])
                after = stop == len(s) or not _RUST_WORD_START.fullmatch(s[stop])
                if not (before and after):
                    continue
            if lstrip:
                start = max(_RUST_WS_END.search(s[:start]).start(), last)
            if rstrip:
                stop += _RUST_WS.match(s, stop).end() - stop
            if last < start:
                out.append((last, start, None))
            out.append((start, stop, tid))
            last = stop
        if last != len(s):
            out.append((last, len(s), None))
        return out

    def _segments(self, text: str):
        """Added tokens out of the raw text, the rest normalized, normalized
        added tokens out of that: yields ``(id, None, None)`` for an added
        token, ``(None, text, at_start)`` for a piece to pre-tokenize."""
        for a, b, tid in self._extract(text, self._raw_matcher):
            if tid is not None:
                yield tid, None, None
                continue
            s = text[a:b]
            if not s:
                continue
            if self._normalize is not None:
                s = self._normalize(s)
            for c, d, tid2 in self._extract(s, self._norm_matcher):
                if tid2 is not None:
                    yield tid2, None, None
                elif c != d:
                    yield None, s[c:d], a == 0 and c == 0

    def encode(self, text: str) -> list:
        """``tokenizers`` ``encode(text).ids``, special tokens added.  Text
        that is not valid Unicode (a lone surrogate) raises
        UnicodeEncodeError, a ValueError, as the library refuses it."""
        text.encode("utf-8")
        ids = []
        for tid, s, at0 in self._segments(text):
            if tid is not None:
                ids.append(tid)
                continue
            pieces = self._pre([(s, at0)]) if self._pre is not None else [(s, at0)]
            for p, _ in pieces:
                ids.extend(self._model.tokenize(p))
        if self._template is None:
            return ids
        out = []
        for x in self._template:
            if x is None:
                out.extend(ids)
            else:
                out.append(x)
        return out

    # ------------------------------------------------------------- decode

    def _token(self, i: int) -> Optional[str]:
        tok = self._added_inv.get(i)
        return tok if tok is not None else self._inv.get(i)

    def decode(self, ids) -> str:
        """``tokenizers`` ``decode(ids, skip_special_tokens=True)``: unknown
        ids are dropped, special tokens skipped."""
        toks = []
        for i in ids:
            tok = self._token(int(i))
            if tok is not None and tok not in self._special:
                toks.append(tok)
        if self._decoders is None:
            return " ".join(toks)
        if self._byte_level_decode:  # the fast path: per-token bytes, cached
            parts = []
            for t in toks:
                b = self._tok_bytes.get(t)
                if b is None:
                    b = self._tok_bytes[t] = _token_bytes(t)
                parts.append(b)
            return b"".join(parts).decode("utf-8", "replace")
        for fn in self._decoders:
            toks = fn(toks)
        return "".join(toks)
