"""The one traffic generator: the same seed gives the same work, another
seed the same sizes in another order with other contents."""

import numpy as np
import pytest

from benchmark.harness import common, traffic
from benchmark.harness.tokenizer import StandInTokenizer, ids_of
from benchmark.reference import text as rtext

SEEDS = (2 ** 31 + 7, 3_000_000_001)


def _conv(seed):
    return traffic.conversations(common.traffic("stage2b_conversations"),
                                 seed, StandInTokenizer(), 576)


def test_conversations_repeat_for_a_seed_and_differ_for_another():
    a, b = _conv(SEEDS[0]), _conv(SEEDS[1])
    assert a == _conv(SEEDS[0])
    assert a != b


def test_conversations_have_the_mixs_sizes_on_every_seed():
    mix = common.traffic("stage2b_conversations")
    tok = StandInTokenizer()
    sizes = []
    for seed in SEEDS:
        n = sorted(len(rtext.conversation_ids(r["conversations"], tok)[0]) - 1
                   + 576 for r in _conv(seed))
        assert n[0] == mix["real_tokens"][0] and n[-1] == mix["real_tokens"][1]
        sizes.append(n)
    assert sizes[0] == sizes[1]


def test_every_conversation_has_answer_tokens_to_learn():
    tok = StandInTokenizer()
    for r in _conv(SEEDS[0]):
        _, labels = rtext.conversation_ids(r["conversations"], tok)
        assert sum(1 for x in labels if x != rtext.IGNORE) > 20


def test_questions_and_images_repeat_for_a_seed_and_differ_for_another():
    mix = common.traffic("short_vqa")
    qa, qb = traffic.questions(mix, SEEDS[0]), traffic.questions(mix, SEEDS[1])
    assert qa == traffic.questions(mix, SEEDS[0]) and qa != qb
    assert sorted(len(q["question"]) for q in qa) == \
        sorted(len(q["question"]) for q in qb)
    assert sorted(q["max_new_tokens"] for q in qa) == \
        sorted(q["max_new_tokens"] for q in qb)
    ia, ib = traffic.images(mix, SEEDS[0]), traffic.images(mix, SEEDS[1])
    assert all(np.array_equal(x, y) for x, y in
               zip(ia, traffic.images(mix, SEEDS[0])))
    assert [x.shape for x in ia] == [x.shape for x in ib]
    assert not np.array_equal(ia[0], ib[0])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 9, 40])
def test_words_have_the_asked_length(n):
    rng = np.random.default_rng(n)
    assert len(traffic._words(rng, n)) == n


def test_the_tokenizer_text_gives_its_ids_back():
    tok = StandInTokenizer()
    ids = [0, 5, 151935, 42]
    assert ids_of(tok.decode(ids)) == ids
