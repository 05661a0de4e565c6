"""The port's WordPiece tokenizer.json (engine/tokenizer_json.py:
BertNormalizer, BertPreTokenizer, the WordPiece model and decoder) against
the JAX package's HFTokenizer (the `tokenizers` package) on a vocabulary
built here: ids equal and decoded text equal for text with accents, CJK,
punctuation and symbols, control and format characters, unknown words,
a word over max_input_chars_per_word, and the special tokens, under each
normalizer setting.  Encoding adds no [CLS] / [SEP]: the JAX tokenizer
encodes with add_special_tokens=False."""

import json

import pytest

from kserve_tpu.engine.tokenizer import HFTokenizer as JHFTokenizer
from kserve_tpu_torch.engine.tokenizer import HFTokenizer
from kserve_tpu_torch.engine.tokenizer_json import TokenizerJSON

SPECIAL = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDS = ["the", "a", "cafe", "café", "resume", "un", "##aff", "##able", "hello",
         "world", "don", "t", "'", "s", "##s", "is", "naive", "##ly", "play", "##ing",
         "straße", "ßtra", "σας", "ΣΑΣ", "中", "国", "人", "𠀀", "\U0002b920", "e", "é",
         "!", ",", ".", "?", "$", "5", "##5", "-", "(", ")", "¿", "«", "»", "…",
         "x", "##x", "y", "z", "n't", "do", "not"]
TEXTS = [
    "Hello, world! The café is naive.",
    "Résumé: un-aff-able ¿qué? «naïvely»… playing",
    "中国人 𠀀\U0002b920\U0002b820 x中y",
    "don't $55 (x) -- is the DO NOT",
    "ctrl\x00a\x07b​c﻿d�e tab\tnew\nret\r　 end",
    "unknownword supercalifragilistic unaffable unaffablex",
    "ΣΑΣ σας STRAßE straße",
    "[MASK] the [CLS]x[SEP] [UNK]",
    "",
    "   ",
]
NORMALIZERS = {
    "lowercase": dict(strip_accents=None, lowercase=True),
    "cased": dict(strip_accents=None, lowercase=False),
    "strip_only": dict(strip_accents=True, lowercase=False),
    "lower_keep_accents": dict(strip_accents=False, lowercase=True),
    "no_clean_no_cjk": dict(clean_text=False, handle_chinese_chars=False,
                            strip_accents=None, lowercase=True),
}


def tokenizer_json(normalizer: dict, max_chars: int = 12, cleanup: bool = True) -> dict:
    vocab = {t: i for i, t in enumerate(SPECIAL + WORDS)}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True} for t in SPECIAL],
        "normalizer": dict({"type": "BertNormalizer", "clean_text": True,
                            "handle_chinese_chars": True}, **normalizer),
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": cleanup},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": max_chars, "vocab": vocab},
    }


def _dir(tmp_path, data: dict):
    (tmp_path / "tokenizer.json").write_text(json.dumps(data))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"cls_token": "[CLS]", "sep_token": "[SEP]"}))
    return str(tmp_path)


@pytest.mark.parametrize("normalizer", sorted(NORMALIZERS))
def test_ids_and_text_match_the_jax_tokenizer(tmp_path, normalizer):
    d = _dir(tmp_path, tokenizer_json(NORMALIZERS[normalizer]))
    want, got = JHFTokenizer(d), HFTokenizer(d)
    assert got.vocab_size == want.vocab_size
    for text in TEXTS:
        ids = want.encode(text, add_bos=False)
        assert got.encode(text, add_bos=False) == ids, text
        assert got.decode(ids) == want.decode(ids), text


@pytest.mark.parametrize("cleanup", [True, False])
def test_decode_of_every_id_matches(tmp_path, cleanup):
    """Every id in order (special ones skipped, `##` pieces joined,
    cleanup's contractions) and ids no vocabulary entry has."""
    d = _dir(tmp_path, tokenizer_json(NORMALIZERS["lowercase"], cleanup=cleanup))
    want, got = JHFTokenizer(d), HFTokenizer(d)
    ids = list(range(len(SPECIAL) + len(WORDS)))
    for seq in (ids, ids[::-1], [10, 11, 12, 13], [5, 999, 6, 7], []):
        assert got.decode(seq) == want.decode(seq), seq


def test_wordpiece_greedy_longest_match_and_unk():
    tok = TokenizerJSON(tokenizer_json(NORMALIZERS["lowercase"], max_chars=10))
    vocab = tok.model.vocab
    assert tok.encode("unaffable") == [vocab["un"], vocab["##aff"], vocab["##able"]]
    # one part no piece matches: the whole word is [UNK]
    assert tok.encode("unaffablez") == [vocab["[UNK]"]]
    # 11 characters > max_input_chars_per_word 10
    assert tok.encode("playingplay") == [vocab["[UNK]"]]
    assert tok.encode("[MASK]") == [vocab["[MASK]"]]


def test_missing_unk_token_raises():
    data = tokenizer_json(NORMALIZERS["lowercase"])
    data["model"]["unk_token"] = "<nope>"
    with pytest.raises(ValueError, match="unk_token"):
        TokenizerJSON(data).encode("zzz")
