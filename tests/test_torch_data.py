"""The port's data path (llavamod_tpu_torch/data/{preprocess,dataset,
collator}.py, train/{sampler,loader}.py) against the JAX package's on the
same inputs: every conversation template preprocesses to the same ids and
labels; the supervised and preference datasets give the same items and both
collators the same arrays from the same JSON, PNGs and stub tokenizer; the
samplers give the same index order for the same seed over three epochs;
the threaded loader gives the same batches in the same order with 0 and 4
workers.  Every comparison is exact.

Both packages' image preprocessors take their C++ batch paths, which give
the same bits (the JAX one from tests/test_torch_native_prep.py's
`jax_native` build, which no order of the test files can leave unloaded);
on the PIL path (LLAVAMOD_NO_NATIVE=1 for the port, the JAX package's PIL
fallback) the items are the same too."""

import json

import numpy as np
import pytest
from PIL import Image

from llavamod_tpu import conversation as jconv
from llavamod_tpu import mm_utils as jmm
from llavamod_tpu.data import collator as jcoll
from llavamod_tpu.data import dataset as jds
from llavamod_tpu.data import preprocess as jpre
from llavamod_tpu.train import loader as jloader
from llavamod_tpu.train import sampler as jsampler
from llavamod_tpu_torch import mm_utils as tmm
from llavamod_tpu_torch import native
from llavamod_tpu_torch.data import collator as tcoll
from llavamod_tpu_torch.data import dataset as tds
from llavamod_tpu_torch.data import preprocess as tpre
from llavamod_tpu_torch.train import loader as tloader
from llavamod_tpu_torch.train import sampler as tsampler
from test_torch_native_prep import jax_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native")


class StubTok:
    """Character-level ids, no BOS (tests/test_train_run.py's stub)."""
    bos_token_id = None
    pad_token_id = 0

    def __call__(self, text):
        return type("R", (), {"input_ids": [ord(c) % 500 for c in text]})()


class BosTok:
    """Word-level ids with a leading BOS (the v1 / llama_2 assumption)."""
    bos_token_id = 1
    pad_token_id = 0

    def __call__(self, text):
        ids = [1] + [2 + (sum(map(ord, w)) % 97) for w in text.split()]
        return type("R", (), {"input_ids": ids})()


class PilPreprocessor(jmm.ImagePreprocessor):
    """The JAX package's PIL path (its C++ path switched off), held against
    the port's with LLAVAMOD_NO_NATIVE=1."""

    def _native_batch(self, images):
        return None


def _conversation(name):
    human = {"from": "human", "value": "<image>\nWhat is in the picture?"}
    if jconv.get_template(name).style is jconv.SeparatorStyle.PLAIN:
        return [human, {"from": "gpt", "value": "A red bus on a street."}]
    return [human, {"from": "gpt", "value": "A red bus."},
            {"from": "human", "value": "And its colour, exactly?"},
            {"from": "gpt", "value": "Bright red with white stripes."}]


@pytest.mark.parametrize("tok", [StubTok(), BosTok()], ids=["char", "bos"])
@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_preprocess_every_template_is_the_same(name, tok):
    for im_start_end in (False, True):
        kw = dict(num_frames=4, use_im_start_end=im_start_end)
        src_j = jpre.preprocess_multimodal_text([_conversation(name)], **kw)
        src_t = tpre.preprocess_multimodal_text([_conversation(name)], **kw)
        assert src_t == src_j
        want = jpre.preprocess_conversations(src_j, tok, name, 1 << 30)
        got = tpre.preprocess_conversations(src_t, tok, name, 1 << 30)
        assert got.input_ids == want.input_ids
        assert got.labels == want.labels
    # one style function directly, with a length cut that masks the sample
    if name == "qwen":
        t = jconv.get_template(name)
        want = jpre.preprocess_two_style([_conversation(name)], tok, t,
                                         model_max_length=8)
        got = tpre.preprocess_two_style([_conversation(name)], tok,
                                        tpre.conv_lib.get_template(name),
                                        model_max_length=8)
        assert (got.input_ids, got.labels) == (want.input_ids, want.labels)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 records: images of three sizes, one missing file (the black
    fallback), two text-only records, multi-image lists."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(3)
    for i in range(6):
        size = [(32, 32), (40, 24), (17, 50)][i % 3]
        Image.fromarray(rng.randint(0, 256, size + (3,), dtype=np.uint8)
                        ).save(tmp / f"img{i}.png")
    sft, pref = [], []
    for i in range(12):
        human = {"from": "human",
                 "value": f"<image>\nwhat is in image {i}? " + "x " * i}
        answer = {"from": "gpt", "value": f"a red bus number {i} " * (i % 3 + 1)}
        rec = {"image": f"img{i % 6}.png", "conversations": [human, answer]}
        if i == 4:
            rec["image"] = "missing.png"
        if i == 5:
            rec["image"] = [f"img{k}.png" for k in range(6)]
        if i in (3, 7):
            rec = {"conversations": [{"from": "human", "value": "hi " * i},
                                     {"from": "gpt", "value": "hello there"}]}
        sft.append(rec)
        pref.append({"image": f"img{i % 6}.png",
                     "chosen": [human, answer],
                     "rejected": [human, {"from": "gpt", "value": "nothing"}]})
    (tmp / "sft.json").write_text(json.dumps(sft))
    (tmp / "pref.json").write_text(json.dumps(pref))
    return tmp


def _datasets(corpus, kind, template="qwen", pil=False):
    """Both packages' datasets over one corpus: each preprocessor on its C++
    path, or with `pil` (the caller sets LLAVAMOD_NO_NATIVE=1 for the port)
    each on its PIL path."""
    path = str(corpus / ("pref.json" if kind == "pref" else "sft.json"))
    kw = dict(image_folder=str(corpus), template_name=template,
              model_max_length=160, seed=5)
    jcls = jds.PreferenceJsonDataset if kind == "pref" else jds.SupervisedJsonDataset
    tcls = tds.PreferenceJsonDataset if kind == "pref" else tds.SupervisedJsonDataset
    jpp = PilPreprocessor(size=28) if pil else jmm.ImagePreprocessor(size=28)
    return (jcls([path], StubTok(), jpp, **kw),
            tcls([path], StubTok(), tmm.ImagePreprocessor(size=28), **kw))


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray) or isinstance(got[k], np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("kind,template", [("sft", "qwen"), ("sft", "plain"),
                                           ("pref", "qwen")])
def test_dataset_items_and_lengths_are_the_same(corpus, kind, template):
    jd, td = _datasets(corpus, kind, template)
    if template == "plain":   # plain takes one (image, caption) turn pair
        jd.records = [r for r in jd.records if "image" in r]
        td.records = [r for r in td.records if "image" in r]
    assert len(td) == len(jd)
    assert td.modality_lengths == jd.modality_lengths
    for i in range(len(jd)):
        _assert_same(td[i], jd[i])


@pytest.mark.parametrize("kind", ["sft", "pref"])
def test_dataset_items_are_the_same_on_the_pil_path(corpus, kind,
                                                    monkeypatch):
    monkeypatch.setenv("LLAVAMOD_NO_NATIVE", "1")
    jd, td = _datasets(corpus, kind, pil=True)
    native.reset_counts()
    for i in range(len(jd)):
        _assert_same(td[i], jd[i])
    assert native.counts["native"] == 0 and native.counts["pil"] > 0


@pytest.mark.parametrize("kind", ["sft", "pref"])
def test_collators_are_the_same(corpus, kind):
    jd, td = _datasets(corpus, kind)
    kw = dict(max_len=160, num_image_tokens=9, image_size=28, max_images=2,
              pad_id=0)
    if kind == "pref":
        jc, tc = jcoll.DPOCollator(**kw), tcoll.DPOCollator(**kw)
    else:
        jc, tc = jcoll.SupervisedCollator(**kw), tcoll.SupervisedCollator(**kw)
    for rows in ([0, 1, 2, 3], [4, 5, 6, 7], [8, 11]):
        want = jc([jd[i] for i in rows])
        _assert_same(tc([td[i] for i in rows]), want)
    if kind == "pref":   # chosen and rejected share one image tensor
        assert "pixels" in want and "chosen_pixels" not in want


@pytest.mark.parametrize("kind", ["random", "length", "modality"])
def test_samplers_give_the_same_order(kind):
    rng = np.random.RandomState(0)
    lengths = [int(v) * (1 if i % 3 else -1)
               for i, v in enumerate(rng.randint(1, 400, 37))]
    if kind == "random":
        j, t = jsampler.RandomSampler(37, seed=11), tsampler.RandomSampler(37, seed=11)
    else:
        kw = dict(lengths=lengths, group_by_modality=kind == "modality",
                  seed=11)
        j = jsampler.LengthGroupedSampler(4, 2, **kw)
        t = tsampler.LengthGroupedSampler(4, 2, **kw)
    orders = []
    for epoch in range(3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        want = list(iter(j))
        assert list(iter(t)) == want and sorted(want) == list(range(37))
        orders.append(want)
    assert orders[0] != orders[1] != orders[2]
    assert len(t) == len(j)


def test_loader_gives_the_same_batches_with_0_and_4_workers(corpus):
    jd, td = _datasets(corpus, "sft")
    kw = dict(max_len=160, num_image_tokens=9, image_size=28, max_images=2)
    coll_t, coll_j = tcoll.SupervisedCollator(**kw), jcoll.SupervisedCollator(**kw)

    def batches(mod, ds, coll, sampler, workers, n):
        it = mod.infinite_batches(mod.DataLoader(
            ds, 3, coll, sampler=sampler, num_workers=workers, prefetch=2))
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    n = 9          # 4 batches an epoch (12 // 3): crosses two epochs
    want = batches(jloader, jd, coll_j, jsampler.RandomSampler(12, seed=2), 0, n)
    for workers in (0, 4):
        got = batches(tloader, td, coll_t, tsampler.RandomSampler(12, seed=2),
                      workers, n)
        assert len(got) == n
        for g, w in zip(got, want):
            _assert_same(g, w)
    assert len(tloader.DataLoader(td, 5, coll_t)) == len(
        jloader.DataLoader(jd, 5, coll_j)) == 2
