"""Port parity: the pure-Python ``tokenizer.json`` reader.

The JAX package's ``load_tokenizer`` wraps the ``tokenizers`` library; the
port's reads the file itself (``serving/engine/hf_tokenizer.py``).  Both
load the same files from a model dir, and on every tokenizer family that
``hf_convert`` converts they give the same ids, the same decodes and the
same ``vocab_size``, on hypothesis strings and on random id lists:

- the committed Llama-3-shaped fixture (``tests/fixtures/``: the Split
  regex, ByteLevel without its regex, ``ignore_merges``, the BOS template,
  Llama-3's 256 special names);
- a GPT-2 style ``ByteLevel(use_regex=True)`` BPE, with and without
  ``add_prefix_space``, with ``lstrip``, ``rstrip`` and ``single_word``
  added tokens;
- SentencePiece-style BPEs (Llama-2, Mistral, Gemma): the ``Prepend`` /
  ``Replace`` normalizer or ``Metaspace``, or Gemma's ``Replace``
  normalizer with its ``Split(" ", merged_with_previous)``,
  ``byte_fallback`` with ``<0xNN>`` tokens or ``unk_token`` with
  ``fuse_unk``, and the ``Replace`` / ``ByteFallback`` / ``Fuse`` /
  ``Strip`` decoder, or ``Metaspace`` both ways (``transformers``'
  converters' shapes);
- ``WordLevel`` with ``Whitespace`` (the JAX package's own test);
- a byte-level BPE behind ``Split`` with each behaviour the reader takes.

The committed ids equal the library's and the port's; the constrain token
table is the same list in both packages; an unsupported component raises
and names itself; the padded 128256-entry tokenizer that ``chip_smoke.py``
serves encodes as the library does."""

import json
import os
import runpy

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,  # noqa: E402
                        normalizers, pre_tokenizers, processors, trainers)

from kubeflow_tpu.serving import constrain as JC  # noqa: E402
from kubeflow_tpu.serving.engine import serve as JS  # noqa: E402
from kubeflow_tpu_torch.serving import constrain as C  # noqa: E402
from kubeflow_tpu_torch.serving.engine import serve as S  # noqa: E402
from kubeflow_tpu_torch.serving.engine.hf_tokenizer import HFTokenizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
LLAMA3 = os.path.join(FIXTURES, "tokenizer_llama3_shape.json")
STRINGS = os.path.join(FIXTURES, "tokenizer_llama3_shape_strings.json")


def _corpus() -> list:
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    extra = ["naïve café — 日本語 テキスト 中文 😀 Привет мир 12345 don't it's",
             "  indented\n\n\tcode(x) {return x+1;}  \r\n"]
    return [text[i:i + 2000] for i in range(0, len(text), 2000)] + extra * 5


def _gpt2(prefix: bool) -> str:
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=prefix)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=700, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(["<|endoftext|>",
                            AddedToken("<mask>", lstrip=True, special=True),
                            AddedToken("<sep>", rstrip=True, special=True)])
    tok.add_tokens([AddedToken("cat", single_word=True), " the port"])
    return tok.to_str()


def _sentencepiece(style: str) -> str:
    """A Llama-2 / Mistral / Gemma-shaped BPE: the vocab is <unk>, <s>,
    </s>, the 256 byte tokens, then merges learned on '▁'-joined text."""
    t = Tokenizer(models.BPE())
    t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                         normalizers.Replace(" ", "▁")])
    t.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="never")
    t.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=600, show_progress=False, limit_alphabet=70))
    learned = json.loads(t.to_str())["model"]
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    vocab = {s: i for i, s in enumerate(specials)}
    for s in sorted(learned["vocab"], key=learned["vocab"].get):
        vocab.setdefault(s, len(vocab))
    fallback = style != "unk"
    model = models.BPE(vocab=vocab, merges=[tuple(m) for m in learned["merges"]],
                       unk_token="<unk>", fuse_unk=True, byte_fallback=fallback)
    tok = Tokenizer(model)
    steps = [decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse()]
    if style == "metaspace":
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first", split=False)
    elif style == "spm":  # transformers' SpmConverter: Metaspace both ways
        tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="always")
    elif style == "gemma":  # transformers' GemmaConverter
        tok.normalizer = normalizers.Replace(" ", "▁")
        tok.pre_tokenizer = pre_tokenizers.Split(" ", "merged_with_previous")
    else:
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                               normalizers.Replace(" ", "▁")])
    if style != "gemma":
        steps.append(decoders.Strip(" ", 1, 0))
    tok.decoder = (decoders.Metaspace(prepend_scheme="always") if style == "spm"
                   else decoders.Sequence(steps))
    tok.add_special_tokens([AddedToken(s, normalized=False, special=True)
                            for s in ("<unk>", "<s>", "</s>")])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", 1)])
    return tok.to_str()


def _split_behaviours() -> str:
    """A byte-level BPE behind every split behaviour the reader takes, on
    string and regex patterns."""
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(" ", "merged_with_previous"),
        pre_tokenizers.Split(Regex(r"\p{N}+"), "merged_with_next"),
        pre_tokenizers.Split(Regex(r"[.,!?]"), "removed"),
        pre_tokenizers.Split(Regex(r"\s+"), "removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=500, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok.to_str()


def _wordlevel() -> str:
    tok = Tokenizer(models.WordLevel({"hello": 7, "world": 3, "[UNK]": 0}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return tok.to_str()


def _llama3() -> str:
    with open(LLAMA3, encoding="utf-8") as f:
        return f.read()


FAMILIES = {
    "llama3": _llama3,
    "gpt2": lambda: _gpt2(False),
    "gpt2_prefix": lambda: _gpt2(True),
    "sentencepiece": lambda: _sentencepiece("normalizer"),
    "sentencepiece_metaspace": lambda: _sentencepiece("metaspace"),
    "sentencepiece_unk": lambda: _sentencepiece("unk"),
    "gemma": lambda: _sentencepiece("gemma"),
    "spm_metaspace_decoder": lambda: _sentencepiece("spm"),
    "split_behaviours": _split_behaviours,
    "wordlevel": _wordlevel,
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (the JAX package's tokenizer, the port's), both loaded by
    ``load_tokenizer`` from the same model dir."""
    out = {}
    for name, make in FAMILIES.items():
        d = tmp_path_factory.mktemp(name)
        (d / "tokenizer.json").write_text(make(), encoding="utf-8")
        out[name] = (JS.load_tokenizer(str(d)), S.load_tokenizer(str(d)))
    return out


def _fragments(lib) -> list:
    """Pieces a prompt is made of: vocabulary entries (as text), added and
    special tokens, whitespace runs, digits and contractions."""
    vocab = lib._tok.get_vocab()
    words = sorted(vocab)[:: max(1, len(vocab) // 60)]
    text = [lib._tok.decode([vocab[w]], skip_special_tokens=False) for w in words]
    added = [t.content for t in lib._tok.get_added_tokens_decoder().values()]
    return text + added + [" ", "  ", "\n", "\n\n", "\t", " \n ", "\r\n", "'s", "'LL",
                           "123", "4567", "é", "😀", "日本", "▁", "<0x41>", "<s", "|>"]


_SETTINGS = settings(max_examples=60, deadline=None,
                     suppress_health_check=[HealthCheck.function_scoped_fixture,
                                            HealthCheck.too_slow])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_vocab_size_and_class(pairs, name):
    jtok, ttok = pairs[name]
    assert type(jtok).__name__ == "HFTokenizer" and isinstance(ttok, HFTokenizer)
    assert S.HFTokenizer is HFTokenizer
    assert ttok.vocab_size == jtok.vocab_size == jtok._tok.get_vocab_size()
    # no ``inv``: the constrain table must decode one id at a time
    assert not hasattr(ttok, "inv")


@pytest.mark.parametrize("name", list(FAMILIES))
@_SETTINGS
@given(data=st.data())
def test_encode_and_decode_match_library(pairs, name, data):
    jtok, ttok = pairs[name]
    frag = st.sampled_from(_fragments(jtok))
    text = data.draw(st.one_of(
        st.text(max_size=40),
        st.lists(st.one_of(frag, st.text(max_size=4)), max_size=12).map("".join)))
    try:
        want = jtok.encode(text)
    except Exception as e:  # noqa: BLE001 — WordLevel without its unk
        with pytest.raises(ValueError):
            ttok.encode(text)
        assert "unk" in str(e).lower() or "UNK" in str(e)
        return
    assert ttok.encode(text) == want, text
    assert ttok.decode(want) == jtok.decode(want), want


@pytest.mark.parametrize("name", list(FAMILIES))
@_SETTINGS
@given(data=st.data())
def test_decode_random_ids_matches_library(pairs, name, data):
    """Any id list, specials, byte tokens and out-of-range ids included:
    the same string, U+FFFD counts and all."""
    jtok, ttok = pairs[name]
    ids = data.draw(st.lists(st.integers(0, jtok.vocab_size + 3), max_size=12))
    assert ttok.decode(ids) == jtok.decode(ids), ids


@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_single_id_decodes_as_the_library(pairs, name):
    jtok, ttok = pairs[name]
    for i in range(jtok.vocab_size + 2):
        assert ttok.decode([i]) == jtok.decode([i]), i


@pytest.mark.parametrize("name", list(FAMILIES))
def test_token_bytes_tables_equal(pairs, name):
    jtok, ttok = pairs[name]
    assert C.token_bytes_from_tokenizer(ttok) == JC.token_bytes_from_tokenizer(jtok)


def test_committed_fixture_ids_are_the_librarys():
    with open(STRINGS, encoding="utf-8") as f:
        cases = json.load(f)["cases"]
    lib = Tokenizer.from_str(_llama3())
    assert len(cases) >= 50
    for c in cases:
        assert lib.encode(c["text"]).ids == c["ids"], c["text"]
        assert lib.decode(c["ids"], skip_special_tokens=True) == c["decode"]


def test_port_reader_gives_the_committed_ids():
    """What ``chip_smoke.py`` checks on the card, without the library."""
    with open(STRINGS, encoding="utf-8") as f:
        meta = json.load(f)
    tok = HFTokenizer(_llama3())
    assert tok.vocab_size == meta["vocab_size"] == 6256
    for c in meta["cases"]:
        assert tok.encode(c["text"]) == c["ids"], c["text"]
        assert tok.decode(c["ids"]) == c["decode"]
        if "<|" not in c["text"]:
            assert c["decode"] == c["text"]
    # the BOS template, then Llama-3's special names right after the learned vocab
    assert tok.encode("hi")[0] == 6000
    assert tok.encode("<|eot_id|>") == [6000, 6009]


def test_llama3_regex_edge_cases_match_library(pairs):
    jtok, ttok = pairs["llama3"]
    for s in ["'S 'ſ 'ſx 'LL 'Ll 'rE 'VE", "aᲉb \U0002ebf0 x", "١٢٣٤ 12345",
              "x  \n\n  y", "   ", "a b　c d", "\x1c\x1d\x1e\x1f",
              "word\r\n\r\n", "ŉ İı ǅ", "́ͅa"]:
        assert ttok.encode(s) == jtok.encode(s), s


def test_serve_load_tokenizer_kinds(tmp_path):
    (tmp_path / "tokenizer.json").write_text(_wordlevel())
    tok = S.load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    assert tok.encode("hello world") == [7, 3]
    assert tok.decode([7, 3]) == "hello world"  # no decoder: joined by a space
    flat = tmp_path / "flat"
    flat.mkdir()
    (flat / "tokenizer.json").write_text(json.dumps({"hi": 1, "yo": 2}))
    assert isinstance(S.load_tokenizer(str(flat)), S.VocabTokenizer)
    assert isinstance(S.load_tokenizer(""), S.ByteTokenizer)


def _mutate(path: list, value):
    raw = json.loads(_llama3())
    node = raw
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return json.dumps(raw)


@pytest.mark.parametrize("path,value,named", [
    (["model", "type"], "Unigram", "model.type 'Unigram'"),
    (["model", "dropout"], 0.1, "model.dropout"),
    (["normalizer"], {"type": "NFKC"}, "normalizer.type 'NFKC'"),
    (["pre_tokenizer", "pretokenizers", 1], {"type": "Digits", "individual_digits": True},
     "pre_tokenizer.pretokenizers[1].type 'Digits'"),
    (["pre_tokenizer", "pretokenizers", 0, "pattern"], {"Regex": r"\p{Lu}+"}, r"\p{Lu}"),
    (["pre_tokenizer", "pretokenizers", 0, "behavior"], "Contiguous", "behavior 'Contiguous'"),
    (["pre_tokenizer", "pretokenizers", 1], {"type": "WhitespaceSplit"},
     "pre_tokenizer.pretokenizers[1].type 'WhitespaceSplit'"),
    (["pre_tokenizer", "pretokenizers", 0, "pattern"], {"Regex": r"\w+"}, r"\w"),
    (["post_processor"], {"type": "BertProcessing", "sep": ["a", 1], "cls": ["b", 2]},
     "post_processor.type 'BertProcessing'"),
    (["decoder"], {"type": "WordPiece", "prefix": "##", "cleanup": True},
     "decoder.type 'WordPiece'"),
    (["truncation"], {"max_length": 8, "strategy": "LongestFirst", "stride": 0,
                      "direction": "Right"}, "truncation"),
    (["padding"], {"strategy": "BatchLongest"}, "padding"),
])
def test_unsupported_component_is_refused_by_name(path, value, named):
    with pytest.raises(ValueError) as e:
        HFTokenizer(_mutate(path, value))
    assert named in str(e.value)


def test_chip_smoke_padded_tokenizer_matches_library():
    """Phase 5j serves the fixture padded to Llama-3's 128256 entries
    (filler tokens no pre-token can equal, the specials at 128000-128255);
    the padded file encodes and decodes as the library does."""
    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"), run_name="not_main")
    data = smoke["padded_llama3_tokenizer"](_llama3(), 128256)
    lib, port = Tokenizer.from_str(data), HFTokenizer(data)
    assert port.vocab_size == lib.get_vocab_size() == 128256
    with open(STRINGS, encoding="utf-8") as f:
        cases = json.load(f)["cases"]
    for c in cases:
        want = lib.encode(c["text"]).ids
        assert port.encode(c["text"]) == want
        assert want[0] == 128000
        # learned ids are the fixture's, specials move to Llama-3's ids
        assert [i if i < 6000 else i - 6000 + 128000 for i in c["ids"]] == want
    for i in list(range(5990, 6010)) + [127999, 128000, 128009, 128255]:
        assert port.decode([i]) == lib.decode([i], skip_special_tokens=True)
