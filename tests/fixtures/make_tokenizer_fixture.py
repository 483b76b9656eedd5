"""Regenerate the Llama-3-shaped tokenizer fixture and the Unicode class
tables of the port's ``tokenizer.json`` reader.

    python tests/fixtures/make_tokenizer_fixture.py

Needs the ``tokenizers`` library (offline; nothing is downloaded).  Writes:

* ``tests/fixtures/tokenizer_llama3_shape.json``: a byte-level BPE trained
  on this repository's JAX sources (code only) and paper summary, with
  Llama-3's components
  (the ``Split`` pre-tokenizer on Llama-3's regex, ``ByteLevel(use_regex=
  False)``, BPE with ``ignore_merges``, the ``TemplateProcessing`` that
  prepends ``<|begin_of_text|>``, the ByteLevel decoder) and Llama-3's 256
  special-token names, placed right after the learned vocabulary in
  Llama-3's order;
* ``tests/fixtures/tokenizer_llama3_shape_strings.json``: probe strings with
  the library's ids and decodes for them;
* ``kubeflow_tpu_torch/serving/engine/_unicode_tables.py``: the code-point
  ranges of ``\\p{L}`` and ``\\p{N}`` as the library's Oniguruma regexes
  see them, and of ``\\w`` as its Rust ``regex`` patterns see it (the
  ``Whitespace`` pre-tokenizer, ``single_word`` added tokens), probed code
  point by code point.
"""

from __future__ import annotations

import glob
import io
import json
import os
import sys
import tokenize

from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, processors, trainers

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
LEARNED = 6000  # byte alphabet + merges; the specials follow at these ids

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def llama3_special_names() -> list:
    """Meta-Llama-3-8B's special tokens in id order (128000..128255)."""
    names = ["<|begin_of_text|>", "<|end_of_text|>"]
    names += [f"<|reserved_special_token_{i}|>" for i in range(4)]
    names += ["<|start_header_id|>", "<|end_header_id|>",
              "<|reserved_special_token_4|>", "<|eot_id|>"]
    names += [f"<|reserved_special_token_{i}|>" for i in range(5, 251)]
    assert len(names) == 256
    return names


PROBES = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "it's they're we've I'm you'll he'd",
    "IT'S THEY'RE WE'VE I'M YOU'LL HE'D",
    "don't can't won't shouldn't",
    "1 12 123 1234 12345 1234567890",
    "pi=3.14159, e=2.71828; 2**10=1024",
    "version 0.22.2 on 2026-10-17 at 06:13:28",
    "  leading spaces",
    "trailing spaces   ",
    "tabs\tand\t\ttabs",
    "line one\nline two\n\nline four\n\n\n",
    "\r\n windows \r\n line \r\n",
    "    indented code:\n        return x + 1\n",
    "def f(x):\n    return {'a': [1, 2, 3]}\n",
    "serve_model(hf://meta-llama/Meta-Llama-3-8B)",
    "naïve café résumé façade jalapeño",
    "Ünïcödé àccénts Ω≈ç√∫˜µ≤≥÷",
    "日本語のテキスト",
    "中文字符和标点。",
    "한국어 텍스트",
    "Привет, мир!",
    "مرحبا بالعالم",
    "שלום עולם",
    "हिन्दी पाठ",
    "emoji 😀🚀🔥 and 👍🏽",
    "family 👨‍👩‍👧‍👦 flags 🇺🇸🇯🇵",
    "math ∀x∈ℝ: x²≥0 ∑ ∏ √",
    "<|begin_of_text|>Hello",
    "User: hi<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\nHello!",
    "text with <|end_of_text|> inside",
    "<|reserved_special_token_7|><|reserved_special_token_250|>",
    "not special: <|begin_of_text| and <|eot_id>",
    "mixed123abc456def",
    "snake_case and camelCase and kebab-case",
    "URL https://example.com/path?q=1&r=2#frag",
    "email someone@example.org",
    "\"quoted\" 'single' `backtick`",
    "!!! ??? ... --- ___",
    "a b c　d",
    "zero​width‍joiner",
    "ﬁ ligature and Ⅻ numeral and ① circled",
    "١٢٣ arabic digits ௧௨௩ tamil",
    "",
    " ",
    "\n",
    "x",
    "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    "the the the the the the the the",
    "JSON: {\"color\": \"blue\", \"count\": 5, \"ok\": true}",
]


def _code_only(text: str) -> str:
    """A Python source with its comments and string literals cut out: the
    identifiers, numbers, operators and layout stay."""
    starts = [0]
    for line in text.splitlines(keepends=True):
        starts.append(starts[-1] + len(line))
    cut, out, last = [], [], 0
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type in (tokenize.COMMENT, tokenize.STRING):
            cut.append((starts[tok.start[0] - 1] + tok.start[1],
                        starts[tok.end[0] - 1] + tok.end[1]))
    for a, b in cut:
        out.append(text[last:a])
        last = b
    out.append(text[last:])
    return "".join(out)


def corpus() -> list:
    """The JAX package's Python sources as code, and the paper's summary and
    snippets as prose."""
    texts = []
    for p in sorted(glob.glob(os.path.join(REPO, "kubeflow_tpu", "**", "*.py"), recursive=True)):
        with open(p, encoding="utf-8") as f:
            texts.append(_code_only(f.read()))
    for name in ("PAPER.md", "SNIPPETS.md"):
        with open(os.path.join(REPO, name), encoding="utf-8") as f:
            texts.append(f.read())
    return texts


def make_fixture() -> None:
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=LEARNED, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(corpus(), trainer)
    assert tok.get_vocab_size() == LEARNED, tok.get_vocab_size()
    names = llama3_special_names()
    tok.add_special_tokens(names)
    bos = tok.token_to_id(names[0])
    assert bos == LEARNED
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single=f"{names[0]} $A", pair=f"{names[0]} $A {names[0]}:1 $B:1",
            special_tokens=[(names[0], bos)])])
    raw = json.loads(tok.to_str())
    raw["model"]["ignore_merges"] = True  # the trainer keeps the flag; pin it
    data = json.dumps(raw, ensure_ascii=False, separators=(",", ":"))
    tok = Tokenizer.from_str(data)
    with open(os.path.join(HERE, "tokenizer_llama3_shape.json"), "w", encoding="utf-8") as f:
        f.write(data)
    cases = []
    for s in PROBES:
        ids = tok.encode(s).ids
        cases.append({"text": s, "ids": ids,
                      "decode": tok.decode(ids, skip_special_tokens=True)})
    with open(os.path.join(HERE, "tokenizer_llama3_shape_strings.json"), "w",
              encoding="utf-8") as f:
        json.dump({"tokenizers_version": __import__("tokenizers").__version__,
                   "vocab_size": tok.get_vocab_size(), "cases": cases},
                  f, ensure_ascii=False, indent=0)
    print("fixture", len(data), "bytes, vocab", tok.get_vocab_size())


def _ranges(pred) -> list:
    out, start = [], None
    for cp in range(0x110001):
        ok = cp <= 0x10FFFF and not 0xD800 <= cp <= 0xDFFF and pred(chr(cp))
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            out.append((start, cp - 1))
            start = None
    return out


def make_tables() -> None:
    def onig(pattern):
        split = pre_tokenizers.Split(Regex(pattern), "removed")
        return lambda c: split.pre_tokenize_str(c) == []

    ws = pre_tokenizers.Whitespace()
    tables = {
        "LETTER": _ranges(onig(r"\p{L}")),
        "NUMBER": _ranges(onig(r"\p{N}")),
        "WORD": _ranges(lambda c: [p for p, _ in ws.pre_tokenize_str("a" + c)] == ["a" + c]),
    }
    import tokenizers

    lines = [
        '"""Unicode classes of the HuggingFace ``tokenizers`` library, as code-point',
        "ranges (inclusive), for ``hf_tokenizer.py``.",
        "",
        f"Probed from ``tokenizers`` {tokenizers.__version__} code point by code point by",
        "``tests/fixtures/make_tokenizer_fixture.py`` (do not edit by hand):",
        "``LETTER`` and ``NUMBER`` are ``\\\\p{L}`` and ``\\\\p{N}`` of its Oniguruma",
        "regexes (``Split`` patterns, the ByteLevel regex), ``WORD`` is ``\\\\w`` of",
        "its Rust ``regex`` patterns (the ``Whitespace`` pre-tokenizer, ``single_word``",
        "added tokens).  Python's ``unicodedata`` is an older Unicode than the",
        "library's tables, so the reader does not derive these from it.",
        '"""',
        "",
    ]
    for name, rs in tables.items():
        lines.append(f"{name} = (")
        row = []
        for lo, hi in rs:
            row.append(f"(0x{lo:X}, 0x{hi:X}),")
            if len(row) == 4:
                lines.append("    " + " ".join(row))
                row = []
        if row:
            lines.append("    " + " ".join(row))
        lines.append(")")
        lines.append("")
    path = os.path.join(REPO, "kubeflow_tpu_torch", "serving", "engine", "_unicode_tables.py")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print("tables", {k: len(v) for k, v in tables.items()})


if __name__ == "__main__":
    what = sys.argv[1:] or ["fixture", "tables"]
    if "fixture" in what:
        make_fixture()
    if "tables" in what:
        make_tables()
