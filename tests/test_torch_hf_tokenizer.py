"""The port's HF tokenizer reader (``models/hf_tokenizer.py``) against
``transformers`` / ``tokenizers``, which the port does not import: a
byte-level BPE trained locally with Llama 3's pre-tokenizer, special
tokens, BOS post-processing, space cleanup and a chat template, and BERT
WordPiece tokenizers (``tokenizer.json`` and ``vocab.txt`` dirs).  Ids,
decodes and chat strings must equal the library's on fixed strings and on
``hypothesis`` text; ``load_tokenizer`` reads such dirs and raises on
unreadable ones; chip_smoke's library-free tokenizer files read the same
through both."""

import json
import os
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from sdag_tpu_torch.models.hf_tokenizer import HFTokenizer, translate_regex
from sdag_tpu_torch.models.tokenizer import ByteTokenizer, load_tokenizer

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

# Llama 3.1's chat template, tool branches cut (it keeps the globals,
# filters and loop controls the renderer must offer)
LLAMA31_TEMPLATE = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- for message in messages %}
    {%- if message.role not in ['user', 'assistant', 'ipython'] %}
        {{- raise_exception('unknown role ' + message.role) }}
    {%- endif %}
    {%- if message.content is none %}
        {%- continue %}
    {%- endif %}
    {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- if loop.index > 64 %}
        {%- break %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's 2024, isn't it?",
    "Question: who wrote the passage? Answer: the author's friend, "
    "they'll say -- and we've 1234567 reasons.",
    "Ça va? Déjà vu — naïve café, 東京 and 北京 ... numbers 3.14159\r\n"
    "\n tabs\t\there   and   spaces",
    "- Answer: Bodiku was born in Velarmo.\n- Question: where?\n",
]

STRINGS = [
    "", " ", "\n", "Hello world", "It's   fine\r\n\r\n  ok",
    "naïve café ÀÉÎ Ångström", "東京 北京 한국어 日本語", "1234567 89 0.5",
    "<|eot_id|>x<|begin_of_text|>", "a <tool> b", "  <tool>  z<tool>",
    "emoji 😀👍🏽 !! ‽", "don't you're I'M we'LL they'D", "\x00\x1c\x1d x",
    "ſ 'ſ 'S 'ſt", "tab\tx　y z w\x85v", "word   \n  next",
    "The cat sat . Really ? yes ! a , b ' c n't 'm 's 've 're do not",
    "- Question: Where was Bodiku born?\n- Answer:",
    "[CLS] the [SEP] [MASK] x", "́̀ä", "ᾼ ǅ Σσς ΣΑΣ",
    "<tool><tool>", " <tool>\t<tool> x", "<|eot_id|><|eot_id|>",
    "<|begin_of_text|", "<<|eot_id|>>", "x  <tool>", "[SEP][SEP] [CLS]",
]


def _llama_dir(path, corpus=CORPUS, vocab_size=420):
    """A Llama-3-style byte-level BPE trained with ``tokenizers``."""
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                            pre_tokenizers, processors, trainers)
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(chip_smoke.LLAMA3_PATTERN),
                             behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(list(corpus) * 10, trainer)
    tok.add_special_tokens(chip_smoke.LLAMA3_SPECIALS[:12])
    tok.add_tokens([AddedToken("<tool>", lstrip=True, rstrip=True,
                               normalized=False, special=False)])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|> $B",
            special_tokens=[("<|begin_of_text|>", bos)])])
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>",
                   "eos_token": "<|eot_id|>",
                   "clean_up_tokenization_spaces": True,
                   "chat_template": LLAMA31_TEMPLATE}, fh)
    return str(path)


BERT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat",
              "sat", "on", "mat", "passage", "query", ":", "a", "ran", "##s",
              "##ing", "hello", "world", "do", "not", "don", "'", "t", "n",
              ".", ",", "?", "!", "cafe", "naive", "东", "京", "北", "12",
              "##3", "##45", "1", "2", "3", "##e", "c", "##a", "##f", "d",
              "##o", "##n", "##t", "-", "s", "x", "##x", "σ", "##ς"]


def _bert_json_dir(path):
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors)
    vocab = {w: i for i, w in enumerate(BERT_WORDS)}
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]",
                                     max_input_chars_per_word=12))
    tok.normalizer = normalizers.BertNormalizer(lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.add_special_tokens(BERT_WORDS[:5])
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.decoder = decoders.WordPiece(prefix="##")
    os.makedirs(path, exist_ok=True)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "BertTokenizer",
                   "do_lower_case": True}, fh)
    return str(path)


def _bert_vocab_dir(path):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(BERT_WORDS) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (the library's tokenizer, the port's), read from one dir."""
    from transformers import BertTokenizerFast, PreTrainedTokenizerFast
    root = tmp_path_factory.mktemp("tok")
    out = {}
    d = _llama_dir(root / "llama")
    out["llama_bpe"] = (PreTrainedTokenizerFast.from_pretrained(d),
                        HFTokenizer.from_dir(d))
    d = _bert_json_dir(root / "bert_json")
    out["bert_tokenizer_json"] = (BertTokenizerFast.from_pretrained(d),
                                  HFTokenizer.from_dir(d))
    d = _bert_vocab_dir(root / "bert_vocab")
    out["bert_vocab_txt"] = (BertTokenizerFast.from_pretrained(d),
                             HFTokenizer.from_dir(d))
    return out


NAMES = ["llama_bpe", "bert_tokenizer_json", "bert_vocab_txt"]


@pytest.mark.parametrize("name", NAMES)
def test_ids_and_decodes_equal_transformers_on_fixed_strings(pairs, name):
    ref, mine = pairs[name]
    for s in STRINGS + CORPUS:
        for add in (False, True):
            assert mine.encode(s, add_special_tokens=add) == ref.encode(
                s, add_special_tokens=add), (s, add)
        ids = ref.encode(s, add_special_tokens=True)
        for skip in (False, True):
            assert mine.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), (s, skip)
            assert mine.decode(ids, skip_special_tokens=skip,
                               clean_up_tokenization_spaces=False) == \
                ref.decode(ids, skip_special_tokens=skip,
                           clean_up_tokenization_spaces=False), (s, skip)


@pytest.mark.parametrize("name", NAMES)
def test_special_token_ids_equal_transformers(pairs, name):
    ref, mine = pairs[name]
    for attr in ("eos_token_id", "bos_token_id", "cls_token_id",
                 "sep_token_id", "unk_token_id"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.clean_up_tokenization_spaces == \
        ref.clean_up_tokenization_spaces
    # the JAX loader pads with eos when the files name no pad token
    want_pad = ref.pad_token_id if ref.pad_token is not None \
        else ref.eos_token_id
    assert mine.pad_token_id == want_pad
    if name == "llama_bpe":
        assert mine.cls_token_id is None and mine.sep_token_id is None


@pytest.mark.parametrize("name", NAMES)
def test_random_ids_decode_like_transformers(pairs, name):
    """Ids anywhere in an 8B-sized vocab (most have no token and decode to
    nothing), partial UTF-8 byte tokens included."""
    import numpy as np
    ref, mine = pairs[name]
    rng = np.random.default_rng(0)
    top = max(mine._id_to_token) + 40
    for n in range(200):
        ids = rng.integers(0, top, size=int(rng.integers(0, 24))).tolist()
        if n % 3 == 0:
            ids += rng.integers(0, 130000, size=3).tolist()
        for skip in (False, True):
            assert mine.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), ids
    # numpy ids, as Generator.generate passes them
    assert mine.decode(np.asarray([5, 6, 7], np.int32)) == ref.decode(
        [5, 6, 7])


def _category_unchanged_since_unicode_3_2(c: str) -> bool:
    """The port classifies characters by Python's ``unicodedata``; the
    tokenizers library by its crates' older tables (BERT punctuation by
    the ``unicode_categories`` crate), so a character assigned in a recent
    Unicode version (U+11B00 DEVANAGARI HEAD MARK, Po since 15.0) splits
    differently.  The property draws characters whose category is the
    same in Unicode 3.2 and today, the ones every table agrees on
    (unassigned code points included)."""
    return unicodedata.ucd_3_2_0.category(c) == unicodedata.category(c)


@settings(max_examples=400, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(text=st.text(st.characters(exclude_categories=["Cs"]).filter(
    _category_unchanged_since_unicode_3_2)))
def test_hypothesis_text_encodes_and_decodes_like_transformers(pairs, text):
    for name in NAMES:
        ref, mine = pairs[name]
        ids = ref.encode(text, add_special_tokens=True)
        assert mine.encode(text, add_special_tokens=True) == ids, name
        assert mine.decode(ids) == ref.decode(ids), name


def test_chat_template_renders_like_transformers(pairs):
    ref, mine = pairs["llama_bpe"]
    chats = [
        [{"role": "system", "content": "  You answer briefly.\n"},
         {"role": "user", "content": "hi \x00DOCS\x00 there  "}],
        [{"role": "user", "content": "no system"},
         {"role": "assistant", "content": "ok"},
         {"role": "user", "content": "again <|eot_id|>"}],
    ]
    for msgs in chats:
        for gen in (True, False):
            want = ref.apply_chat_template(msgs, tokenize=False,
                                           add_generation_prompt=gen)
            got = mine.apply_chat_template(msgs, tokenize=False,
                                           add_generation_prompt=gen)
            assert got == want
            assert mine.apply_chat_template(
                msgs, tokenize=True, add_generation_prompt=gen) == \
                ref.encode(want, add_special_tokens=False)
    import jinja2
    with pytest.raises(jinja2.exceptions.TemplateError, match="role"):
        mine.apply_chat_template([{"role": "robot", "content": "x"}])
    with pytest.raises(ValueError, match="chat template"):
        pairs["bert_vocab_txt"][1].apply_chat_template(chats[0])


def test_regex_translation_matches_oniguruma_classes():
    import re
    pat = re.compile(translate_regex(chip_smoke.LLAMA3_PATTERN))
    # \x1c is no \s for Oniguruma (Python's own \s would split it off)
    assert pat.findall("a\x1c\x1cb") == ["a", "\x1c\x1c", "b"]
    assert pat.findall("x  y") == ["x", " ", " y"]
    assert pat.findall("東京12345") == ["東京", "123", "45"]
    assert re.fullmatch(translate_regex(r"[^\s\p{L}]+"), "1+2")
    with pytest.raises(NotImplementedError):
        translate_regex(r"[\S]")


@pytest.mark.parametrize("part,value", [
    ("model", {"type": "Unigram", "vocab": [["a", 0.0]]}),
    ("normalizer", {"type": "NFKC"}),
    ("pre_tokenizer", {"type": "Metaspace"}),
    ("decoder", {"type": "Metaspace"}),
    ("post_processor", {"type": "RobertaProcessing"}),
])
def test_unsupported_parts_raise_naming_the_type(tmp_path, pairs, part,
                                                 value):
    src = _bert_json_dir(tmp_path / "src")
    with open(os.path.join(src, "tokenizer.json")) as fh:
        spec = json.load(fh)
    spec[part] = value
    with open(os.path.join(src, "tokenizer.json"), "w") as fh:
        json.dump(spec, fh)
    with pytest.raises(NotImplementedError, match=value["type"]):
        HFTokenizer.from_dir(src)


def test_unigram_trained_with_tokenizers_raises(tmp_path):
    from tokenizers import Tokenizer, models, trainers
    tok = Tokenizer(models.Unigram())
    tok.train_from_iterator(CORPUS * 5, trainers.UnigramTrainer(
        vocab_size=60, show_progress=False))
    tok.save(str(tmp_path / "tokenizer.json"))
    with pytest.raises(NotImplementedError, match="Unigram"):
        load_tokenizer(str(tmp_path))


def test_load_tokenizer_reads_hf_dirs_and_raises_on_unreadable_ones(
        tmp_path, pairs):
    llama = _llama_dir(tmp_path / "llama")
    tok = load_tokenizer(llama)
    assert isinstance(tok, HFTokenizer) and tok.eos_token_id is not None
    assert isinstance(load_tokenizer(_bert_vocab_dir(tmp_path / "v")),
                      HFTokenizer)
    # a dir with no tokenizer files keeps the byte fallback
    (tmp_path / "empty").mkdir()
    assert isinstance(load_tokenizer(str(tmp_path / "empty")), ByteTokenizer)
    # tokenizer files that cannot be read raise (no byte fallback)
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "tokenizer.json").write_text("{not json")
    with pytest.raises(ValueError):
        load_tokenizer(str(tmp_path / "broken"))


def test_chip_smoke_tokenizer_files_read_the_same_through_transformers(
        tmp_path):
    """The library-free Llama-3-style tokenizer phase 9 writes (BPE learned
    in plain Python, 256 specials at 128000) and its BERT vocab."""
    from transformers import BertTokenizerFast, PreTrainedTokenizerFast
    texts = CORPUS + ["- Question: Where was Bodiku born?\n- Answer:"]
    d = str(tmp_path / "llama")
    n_vocab, n_merges = chip_smoke.write_llama_tokenizer(d, texts,
                                                         n_merges=120)
    assert n_merges == 120 and n_vocab == 128000
    ref, mine = PreTrainedTokenizerFast.from_pretrained(d), \
        HFTokenizer.from_dir(d)
    assert mine.eos_token_id == ref.eos_token_id == 128009
    assert mine.bos_token_id == 128000 and mine.pad_token_id == 128009
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": texts[1]}]
    chat = ref.apply_chat_template(msgs, tokenize=False,
                                   add_generation_prompt=True)
    assert mine.apply_chat_template(msgs) == chat
    for s in STRINGS + texts + [chat]:
        ids = ref.encode(s, add_special_tokens=False)
        assert mine.encode(s, add_special_tokens=False) == ids, s
        assert mine.decode(ids) == ref.decode(ids), s
    rec = chip_smoke._p9_tokenizer_checks(mine)
    assert rec["prompts"] > 16 and not rec["round_trip_failures"]
    assert not rec["special_failures"]
    v = str(tmp_path / "bert")
    assert chip_smoke.write_bert_vocab(v, texts, vocab_size=400) == 400
    ref, mine = BertTokenizerFast.from_pretrained(v), HFTokenizer.from_dir(v)
    assert (mine.cls_token_id, mine.sep_token_id) == (101, 102)
    for s in STRINGS + texts:
        assert mine.encode(s) == ref.encode(s), s
