"""The PyTorch port's tokenizer.json reader (engine/tokenizer_json.py,
engine/tokenizer.HFTokenizer) against the JAX package's HFTokenizer,
which runs the `tokenizers` package, on tokenizer.json files trained here
with `tokenizers` (a BpeTrainer on a few KB of text): a byte-level one
with Llama-3's Split regex and `ignore_merges` (merges as pairs and as
"a b" strings), a SentencePiece-style one (Replace/Prepend normalizers,
byte_fallback, the Replace/ByteFallback/Fuse/Strip decoders), a
Metaspace one with an unk token, and a GPT-2 one (ByteLevel with its own
regex and a prefix space, NFC, added tokens with lstrip / rstrip /
single_word / normalized).  encode, decode, vocab_size, bos and eos are
held to the reference exactly; so are the chat template through jinja2
and, with jinja2 blocked, the default template."""

import json
import logging
import os
import random
import sys

import pytest
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    trainers,
)

from kserve_tpu.engine.tokenizer import HFTokenizer as JaxHFTokenizer
from kserve_tpu_torch.engine import tokenizer_json as tj
from kserve_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's 2024, we've 12345 items!",
    "Café naïve résumé déjà vu é ä; 你好世界，こんにちは。 🙂🚀 x² Ⅻ",
    "def f(x):\n    return x ** 2  # comment\n\n\nprint(f(3))",
    "  leading spaces and\ttabs\r\nwindows lines  ",
    "I'M SHOUTING, they'LL see; she'd've known",
] * 20
TEXTS = [
    "Hello world", "It's they'll we've I'M she'D", "café naïve ÉCOLE",
    "é ä combininǵ̂ marks", "你好世界 こんにちは 한국어",
    "emoji 🙂🚀👍🏽 👨‍👩‍👧 flag 🇫🇷", "x² Ⅻ ⅷ ½ ٣", "1234567 89 0 3.14159",
    "  many   spaces\n\n\n\tand\r\n tabs  　 x y",
    "<|eot_id|>hi<|eot_id|> there<|start_header_id|>user<|end_header_id|>\n\nyo",
    "", " ", "\n", "a\x1cb\x85c", "zzzqqq unseen ǅ ᾈ", "<|eot_id|>",
    "text<|eot_id|>", "the <tool> call  <tool>x <word> word<word>",
]
SPECIAL = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
           "<|end_header_id|>", "<|eot_id|>"]
CHAT_TEMPLATE = (
    "{% for m in messages %}<|start_header_id|>{{ m['role'] }}<|end_header_id|>"
    "\n\n{{ m['content'] }}<|eot_id|>{% endfor %}{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n{% endif %}")
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "hi <|eot_id|> there ²"}]


def _byte_level():
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=700, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(SPECIAL)
    tok.add_tokens(["<tool>"])  # an added token that is not special
    return tok, {"bos_token": "<|begin_of_text|>",
                 "eos_token": {"content": "<|eot_id|>"},
                 "chat_template": CHAT_TEMPLATE}


def _sentencepiece():
    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>", fuse_unk=True))
    tok.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"],
        limit_alphabet=60, show_progress=False))
    data = json.loads(tok.to_str())
    vocab = data["model"]["vocab"]
    for b in range(256):  # the byte-fallback tokens
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    return Tokenizer.from_str(json.dumps(data)), {"bos_token": "<s>", "eos_token": "</s>"}


def _metaspace():
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=False))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme="first")
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>"],
        limit_alphabet=50, show_progress=False))
    tok.add_special_tokens(SPECIAL)
    return tok, {"bos_token": "<s>", "eos_token": "<unk>"}  # eos id 0


def _gpt2():
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=600, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken("<|eot_id|>", lstrip=True, rstrip=True)])
    tok.add_tokens([AddedToken("<word>", single_word=True),
                    AddedToken("café", normalized=True)])
    return tok, {"eos_token": "<|eot_id|>", "chat_template": "{% bad syntax"}


BUILDERS = {"byte_level": _byte_level, "sentencepiece": _sentencepiece,
            "metaspace": _metaspace, "gpt2": _gpt2}


def _save(tok, cfg, model_dir, string_merges=False):
    os.makedirs(model_dir, exist_ok=True)
    data = json.loads(tok.to_str())
    if string_merges:
        data["model"]["merges"] = [" ".join(m) for m in data["model"]["merges"]]
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f)
    return str(model_dir)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    dirs = {}
    for name, build in BUILDERS.items():
        tok, cfg = build()
        dirs[name] = _save(tok, cfg, root / name)
        if name == "byte_level":
            dirs["byte_level_string_merges"] = _save(
                tok, cfg, root / "string_merges", string_merges=True)
    return dirs


KINDS = ["byte_level", "byte_level_string_merges", "sentencepiece",
         "metaspace", "gpt2"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_match_tokenizers(model_dirs, kind):
    ref, port = JaxHFTokenizer(model_dirs[kind]), HFTokenizer(model_dirs[kind])
    assert port.vocab_size == ref.vocab_size
    assert (port.bos_token_id, port.eos_token_id) == (ref.bos_token_id,
                                                      ref.eos_token_id)
    for text in TEXTS + [" ".join(CORPUS)]:
        for add_bos in (True, False):
            assert port.encode(text, add_bos) == ref.encode(text, add_bos), text
        ids = ref.encode(text)
        assert port.decode(ids) == ref.decode(ids), text
    rng = random.Random(0)
    for _ in range(300):  # any ids: split byte sequences, specials, unknown ids
        ids = [rng.randrange(ref.vocab_size + 4) for _ in range(rng.randrange(1, 9))]
        assert port.decode(ids) == ref.decode(ids), ids


def test_eos_id_zero_reads_as_absent(model_dirs):
    """The JAX tokenizer's `token_to_id(eos) or -1` turns id 0 into -1; the
    port keeps it (ROADMAP C11)."""
    port = HFTokenizer(model_dirs["metaspace"])
    assert port._tok.token_to_id("<unk>") == 0
    assert port.eos_token_id == JaxHFTokenizer(model_dirs["metaspace"]).eos_token_id == -1


def test_chat_template_matches_jinja2(model_dirs):
    ref, port = (JaxHFTokenizer(model_dirs["byte_level"]),
                 HFTokenizer(model_dirs["byte_level"]))
    assert port.chat_template_mode == "jinja2"
    for gen in (True, False):
        text = port.apply_chat_template(MESSAGES, add_generation_prompt=gen)
        assert text == ref.apply_chat_template(MESSAGES, add_generation_prompt=gen)
        assert port.encode(text) == ref.encode(text)
    # the template's special tokens are one id each (two ends of turn, and
    # the one inside the user's text)
    eot = port._tok.token_to_id("<|eot_id|>")
    assert port.encode(port.apply_chat_template(MESSAGES)).count(eot) == 3


def test_broken_template_falls_back_once(model_dirs, caplog):
    ref, port = JaxHFTokenizer(model_dirs["gpt2"]), HFTokenizer(model_dirs["gpt2"])
    with caplog.at_level(logging.WARNING):
        for _ in range(3):
            assert port.apply_chat_template(MESSAGES) == ref.apply_chat_template(MESSAGES)
    port_warnings = [r for r in caplog.records
                     if r.name == "kserve_tpu_torch.engine.tokenizer"]
    assert len(port_warnings) == 1


def test_without_jinja2_the_default_template_is_logged_once(
        model_dirs, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "jinja2", None)  # import raises
    with caplog.at_level(logging.WARNING):
        port = HFTokenizer(model_dirs["byte_level"])
        texts = [port.apply_chat_template(MESSAGES) for _ in range(3)]
    assert port.chat_template_mode == "default"
    ref = JaxHFTokenizer(model_dirs["byte_level"])
    assert texts == [ref.apply_chat_template(MESSAGES)] * 3
    assert texts[0].startswith("<|system|>\nBe brief.\n")
    logged = [r for r in caplog.records
              if r.name == "kserve_tpu_torch.engine.tokenizer"
              and "jinja2" in r.getMessage()]
    assert len(logged) == 1


def test_load_tokenizer_falls_back_to_bytes(tmp_path, model_dirs):
    from kserve_tpu_torch.engine.tokenizer import ByteTokenizer

    assert isinstance(load_tokenizer(None, 300), ByteTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path), 300), ByteTokenizer)
    assert isinstance(load_tokenizer(model_dirs["gpt2"], 300), HFTokenizer)


# characters of every general category group, and the whitespace that
# Python's \s and Oniguruma's \s disagree on
_POOL = ("aZé́̈ǅᾈ你好ㄱ한ʰ々" "0123456789²½Ⅻ٣" " \t\n\r\x0b\x0c\x1c\x1f\x85"
         "  　" "'\"!?.,;:-_()[]{}" "+<>=$€©🙂👍🏽‍" "sStTmMlLdDrReEvV")


@pytest.mark.parametrize("pattern", [LLAMA3_SPLIT, tj._GPT2_SPLIT,
                                     r"\p{N}| ?\p{P}+|[^\p{L}\s]+|\p{M}+|\S"])
def test_regex_translation_splits_as_oniguruma(pattern):
    """The Split pre-tokenizer over random strings of every character
    class against the `tokenizers` one (Oniguruma)."""
    ref = pre_tokenizers.Split(Regex(pattern), behavior="isolated")
    port = tj._pre_tokenizer({"type": "Split", "pattern": {"Regex": pattern},
                              "behavior": "Isolated", "invert": False})
    rng = random.Random(1)
    for _ in range(300):
        text = "".join(rng.choice(_POOL) for _ in range(rng.randrange(1, 24)))
        want = [p for p, _ in ref.pre_tokenize_str(text)]
        assert [p for p, _ in port([(text, True)])] == want, repr(text)


@pytest.mark.parametrize("behavior", ["removed", "isolated", "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_behaviors(behavior, invert):
    ref = pre_tokenizers.Split(Regex(r"\s+|-"), behavior=behavior, invert=invert)
    cfg = json.loads(ref.__getstate__())
    port = tj._pre_tokenizer(cfg)
    for text in ("a b-c  d", "-a--b- ", "  x", "abc", "- -"):
        want = [p for p, _ in ref.pre_tokenize_str(text)]
        assert [p for p, _ in port([(text, True)])] == want, (text, cfg)


@pytest.mark.parametrize("cfg,name", [
    ({"normalizer": {"type": "NFKC"}}, "NFKC"),
    ({"pre_tokenizer": {"type": "Whitespace"}}, "Whitespace"),
    ({"decoder": {"type": "Metaspace"}}, "Metaspace"),
    ({"model": {"type": "Unigram", "vocab": []}}, "Unigram"),
    ({"model": {"type": "BPE", "vocab": {}, "merges": [], "dropout": 0.1}}, "dropout"),
    ({"truncation": {"max_length": 8}}, "truncation"),
    ({"pre_tokenizer": {"type": "Split", "pattern": {"Regex": r"\p{Greek}"},
                        "behavior": "Isolated", "invert": False}}, "Greek"),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": r"\w+"},
                     "content": ""}}, r"\\w"),
])
def test_unknown_components_raise(cfg, name):
    data = {"model": {"type": "BPE", "vocab": {"a": 0}, "merges": []}, **cfg}
    with pytest.raises(NotImplementedError, match=name):
        tj.TokenizerJSON(data)
