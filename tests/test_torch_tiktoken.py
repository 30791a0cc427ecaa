"""The port's tiktoken tokenizers (llavamod_tpu_torch/interop/
tiktoken_tokenizers.py) against the JAX package's, from the same synthetic
`.tiktoken` vocabularies (256 single bytes and the first 2-byte strings, a
valid BPE rank table; the specials at their real ids): the same ids and
decodes, the same special tables, the directory dispatch, and the image
splice through the port's mm_utils.  One difference is pinned: the port's
qwen-1.0 tokenizer sets eos and pad to <|endoftext|>, the JAX one neither
(ROADMAP Queue 3).  The trainer's `load_tokenizer` picks the tiktoken
tokenizer for a directory with a vocabulary."""

import base64
import itertools

import pytest

from llavamod_tpu import mm_utils as jmm
from llavamod_tpu.interop import tiktoken_tokenizers as jtt
from llavamod_tpu_torch import mm_utils as tmm
from llavamod_tpu_torch.constants import IMAGE_TOKEN_INDEX
from llavamod_tpu_torch.interop import tiktoken_tokenizers as ttt
from llavamod_tpu_torch.train import run as trun
from llavamod_tpu_torch.train.args import ModelArgs

N_RANKS = 4096

TEXTS = [
    "hello world",
    "  leading spaces and\nnewlines\r\n\r\n",
    "mixed UNICODE: café 你好 Ümläut 123",
    "specials inline <|endoftext|> and <|im_start|>chat<|im_end|> tail",
    "NFC normalization: é vs é",
    "code: def f(x):\n    return x ** 2  # comment",
    "",
]
FAMILIES = {"qwen": ("QWenV1Tokenizer", "qwen.tiktoken"),
            "arcade": ("Arcade100kTokenizer", "arcade100k.tiktoken")}


def _synth_vocab(path, n_ranks):
    ranks = [bytes([b]) for b in range(256)]
    ranks += [bytes(p) for p in itertools.islice(
        itertools.product(range(256), repeat=2), n_ranks - 256)]
    with open(path, "w") as fh:
        fh.writelines(base64.b64encode(tok).decode() + f" {r}\n"
                      for r, tok in enumerate(ranks))
    return path


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for fam, (cls, fname) in FAMILIES.items():
        d = tmp_path_factory.mktemp(fam)
        vf = _synth_vocab(str(d / fname), N_RANKS)
        out[fam] = (getattr(jtt, cls)(vf), getattr(ttt, cls)(vf), str(d))
    return out


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_encode_decode_equal_jax(pairs, fam, text):
    ref, ours, _ = pairs[fam]
    ids = ours.convert_tokens_to_ids(ours.tokenize(text))
    assert ids == ref.convert_tokens_to_ids(ref.tokenize(text))
    assert ours.decode(ids) == ref.decode(ids)
    assert (ours.decode(ids, skip_special_tokens=True)
            == ref.decode(ids, skip_special_tokens=True))
    assert ours(text)["input_ids"] == ref(text)["input_ids"]


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_special_tables_equal_jax(pairs, fam):
    ref, ours, _ = pairs[fam]
    assert ours.special_tokens == ref.special_tokens
    assert len(ours) == len(ref) and ours.eod_id == ref.eod_id
    assert ours.im_start_id == ref.im_start_id
    assert ours.im_end_id == ref.im_end_id


def test_qwen_sets_eos_and_pad_where_jax_sets_none(pairs):
    ref, ours, _ = pairs["qwen"]
    assert ours.eos_token == ours.pad_token == "<|endoftext|>"
    assert ours.eos_token_id == ours.pad_token_id == ours.eod_id == 151643
    assert ref.eos_token_id is None and ref.pad_token_id is None
    aref, aours, _ = pairs["arcade"]          # unchanged for arcade100k
    assert aours.eos_token_id == aref.eos_token_id == aours.eod_id
    assert aours.pad_token_id == aref.pad_token_id == 100257


def test_vocab_roundtrip_and_directory_dispatch(pairs, tmp_path):
    _, ours, _ = pairs["qwen"]
    out = tmp_path / "saved"
    out.mkdir()
    (path,) = ours.save_vocabulary(str(out))
    assert path.endswith("qwen.tiktoken")
    loaded = ttt.load_tiktoken_tokenizer(str(out))
    assert isinstance(loaded, ttt.QWenV1Tokenizer)
    assert loaded.tokenize("hello") == ours.tokenize("hello")
    assert ttt.load_tiktoken_tokenizer(str(tmp_path)) is None
    assert ttt.load_tiktoken_tokenizer(str(tmp_path / "none")) is None
    assert isinstance(ttt.load_tiktoken_tokenizer(pairs["arcade"][2]),
                      ttt.Arcade100kTokenizer)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_image_token_splice_equals_jax(pairs, fam):
    ref, ours, _ = pairs[fam]
    prompt = "hi <image>\nthere <|im_end|>"
    got = tmm.tokenizer_image_token(prompt, ours)
    assert got == jmm.tokenizer_image_token(prompt, ref)
    assert got.count(IMAGE_TOKEN_INDEX) == 1


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_trainer_loads_the_tiktoken_tokenizer(pairs, fam):
    _, ours, path = pairs[fam]
    tok = trun.load_tokenizer(ModelArgs(model_name_or_path=path))
    assert type(tok) is type(ours)
    assert tok.tokenize("a red bus") == ours.tokenize("a red bus")
    assert tok.pad_token_id == tok.eos_token_id == ours.eod_id
