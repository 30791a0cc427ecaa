"""The port's copies of the eval host modules (answer_normalize, scorers,
converters, gqa_eval, sqa_prompt, tasks, gpt_judge, webpage_data and the
package's re-exports) against the JAX package's originals: every public
function on the same fixtures, written here, gives the same output (floats
to 1e-12; images compared as pixel arrays).  Then the port's CHAIR repair:
with no table `compute_chair` is the JAX function, with an injected
synonym and double-word table it gives the hand-worked CHAIRs / CHAIRi."""

import base64
import io
import json
import math
import os
import types

import numpy as np
import pytest
from PIL import Image

import llavamod_tpu.eval as jeval_pkg
import llavamod_tpu_torch.eval as teval_pkg
from llavamod_tpu.eval import answer_normalize as j_an
from llavamod_tpu.eval import converters as j_cv
from llavamod_tpu.eval import gpt_judge as j_gj
from llavamod_tpu.eval import gqa_eval as j_gq
from llavamod_tpu.eval import scorers as j_sc
from llavamod_tpu.eval import sqa_prompt as j_sp
from llavamod_tpu.eval import tasks as j_tk
from llavamod_tpu.eval import webpage_data as j_wd
from llavamod_tpu_torch.eval import answer_normalize as t_an
from llavamod_tpu_torch.eval import converters as t_cv
from llavamod_tpu_torch.eval import gpt_judge as t_gj
from llavamod_tpu_torch.eval import gqa_eval as t_gq
from llavamod_tpu_torch.eval import scorers as t_sc
from llavamod_tpu_torch.eval import sqa_prompt as t_sp
from llavamod_tpu_torch.eval import tasks as t_tk
from llavamod_tpu_torch.eval import webpage_data as t_wd

FLOAT_TOL = 1e-12

JAX = types.SimpleNamespace(an=j_an, sc=j_sc, cv=j_cv, gq=j_gq, sp=j_sp,
                            tk=j_tk, gj=j_gj, wd=j_wd, pkg=jeval_pkg,
                            side="jax")
PORT = types.SimpleNamespace(an=t_an, sc=t_sc, cv=t_cv, gq=t_gq, sp=t_sp,
                             tk=t_tk, gj=t_gj, wd=t_wd, pkg=teval_pkg,
                             side="port")


def assert_same(got, want, path="out"):
    """Equal structure and values; floats within FLOAT_TOL, images and
    arrays elementwise."""
    if isinstance(want, Image.Image):
        assert isinstance(got, Image.Image), path
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert abs(got - want) <= FLOAT_TOL, (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _b64_png(color) -> str:
    buf = io.BytesIO()
    Image.new("RGB", (16, 12), color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _gqa_question(answer, structural="query", entailed=(), balanced=True,
                  group="colorQ", steps=2):
    return {"question": f"what color is the thing {answer} ?",
            "answer": answer, "isBalanced": balanced,
            "types": {"structural": structural, "semantic": "attr",
                      "detailed": "queryAttr"},
            "groups": {"global": group, "local": "l"},
            "entailed": list(entailed),
            "semantic": [{"operation": "select", "argument": "thing"}] * steps,
            "imageId": "img0"}


SQA_PROBLEMS = {
    "q1": {"question": "Which is a mammal?", "hint": "Think of fur.",
           "caption": "a photo of animals",
           "choices": ["whale", "trout", "sparrow"], "answer": 0,
           "lecture": "Mammals nurse their young.\nBirds lay eggs.",
           "solution": "A whale nurses its young.\nSo it is a mammal.",
           "image": "q1.png"},
    "q2": {"question": "What color?", "hint": "", "caption": "",
           "choices": ["red", "blue"], "answer": 1,
           "lecture": "", "solution": "Blue because sky.", "image": None},
    "q3": {"question": "Pick  one.", "hint": "double  spaces here",
           "caption": "cap", "choices": ["a", "b", "c", "d"], "answer": 3,
           "lecture": "L text", "solution": ""},
}
SQA_PREDS = {"q1": {"text": "A"}, "q2": {"text": "The answer is A."},
             "q3": {"text": "D. because"}}
GPT4 = {"q1": "The answer is B.", "q2": "no idea", "q3": "The answer is D."}
REQUERY = {"q1": {"text": "The answer is A."}, "q3": {"text": "gibberish"}}
GQA_QUESTIONS = {
    "g1": _gqa_question("red", entailed=["g2"]),
    "g2": _gqa_question("yes", structural="verify", steps=1),
    "g3": _gqa_question("blue", group="shapeQ", steps=3),
    "g4": _gqa_question("green", balanced=False),
    "g5": _gqa_question("no", structural="logical", group=None),
}
GQA_PREDS = {"g1": "red", "g2": "yes", "g3": "wrong", "g4": "green",
             "g5": "yes"}
GQA_CHOICES = {q: {"valid": ["red", "blue", "yes", "wrong", "no"],
                   "plausible": ["red", "yes"]} for q in GQA_QUESTIONS}
ANSWER_ROWS = [{"question_id": "1", "text": "A cat.", "prompt": "p1"},
               {"question_id": "2", "text": "blue", "prompt": "p2"},
               {"question_id": "3", "text": "Two dogs!", "prompt": "p3"}]
MME_ROWS = [
    {"task": "existence", "image_id": "i1", "gt": "Yes", "pred": "Yes."},
    {"task": "existence", "image_id": "i1", "gt": "No", "pred": "No"},
    {"task": "existence", "image_id": "i2", "gt": "Yes", "pred": "No"},
    {"task": "existence", "image_id": "i2", "gt": "No", "pred": "maybe no"},
    {"task": "code_reasoning", "image_id": "c1", "gt": "Yes", "pred": "yes"},
    {"task": "code_reasoning", "image_id": "c1", "gt": "No", "pred": "yes"},
]
REVIEW_QS = [{"question_id": i, "text": f"q{i}", "image": "img.jpg",
              "category": "conv" if i % 2 else "detail"} for i in range(4)]
CONTEXTS = {"img.jpg": {"caption": ["a cat", "on a mat"],
                        "captions": ["a cat", "on a mat"],
                        "instances": [{"category": "cat",
                                       "bbox": [1, 2, 3, 4]}]}}
CHAIR_RECORDS = [
    {"pred_objects": ["dog", "frisbee"], "gt_objects": ["dog", "person"]},
    {"pred_objects": ["Car", "car"], "gt_objects": ["car", "road"]},
    {"pred_objects": [], "gt_objects": ["cat"]},
    {"pred_objects": ["bike", "motor bike"], "gt_objects": ["bicycle"]},
]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Fixture files shared by both sides."""
    root = tmp_path_factory.mktemp("host")
    cols = ["index", "question", "hint", "image", "A", "B", "C", "D"]
    rows = [["0", "What color is object 0?", "a hint", _b64_png((200, 9, 9)),
             "red", "green", "blue", "nan"],
            ["1", "What shape?", "nan", _b64_png((9, 9, 200)), "square",
             "circle", "nan", "nan"],
            ["2", "No picture here?", "", "nan", "yes", "no", "maybe",
             "never"]]
    tsv = root / "mmbench.tsv"
    tsv.write_text("\n".join("\t".join(r) for r in [cols] + rows) + "\n")
    sqa = root / "sqa.json"
    sqa.write_text(json.dumps([
        {"id": "123", "image": "123/image.png", "conversations": [
            {"from": "human",
             "value": "<image>\nQuestion: which?\nOptions:\nA. x\nB. y"},
            {"from": "gpt", "value": "The answer is A."}]},
        {"id": "124", "conversations": [
            {"from": "human", "value": "Question: no image?"},
            {"from": "gpt", "value": "The answer is B."}]}]))
    mmhal = _jsonl(root / "mmhal.jsonl", [
        {"question_id": 7, "question": "Is there a dog?", "image_file": "d.jpg",
         "gt_answer": "no", "question_type": "adversarial",
         "image_content": ["Tree"]},
        {"question": "What is it?", "image_file": "e.jpg"}])
    objhal = _jsonl(root / "objhal.jsonl", [
        {"question_id": 3, "question": "Describe.",
         "image": _b64_png((10, 200, 30))}])
    qbench = root / "qbench.json"
    qbench.write_text(json.dumps([
        {"img_path": "x.jpg", "question": "How sharp?",
         "candidates": ["very", "meh"], "correct_ans": "very"},
        {"id": 9, "img_path": "y.jpg", "question": "Noise?",
         "candidates": ["a", "b", "c"]}]))
    generic_l = _jsonl(root / "generic.jsonl", [
        {"question_id": 1, "text": "hi", "image": "a.png"}])
    generic_j = root / "generic.json"
    generic_j.write_text(json.dumps([{"id": 2, "question": "yo"}]))
    pope_q = _jsonl(root / "pope_q.jsonl", [
        {"question_id": i, "category": ["random", "popular"][i % 2]}
        for i in range(6)])
    pope_a = _jsonl(root / "pope_a.jsonl", [
        {"question_id": i, "text": ["Yes", "No.", "There is not a dog.",
                                    "yes", "no", "Yes, it is"][i]}
        for i in range(6)])
    ann = root / "pope_ann"
    ann.mkdir()
    for cat in ("random", "popular"):
        _jsonl(ann / f"coco_pope_{cat}.json", [
            {"question_id": i, "label": ["yes", "no"][i % 3 == 0]}
            for i in range(6)])
    wq = _jsonl(root / "wq.jsonl", [
        {"question_id": 2, "text": "Q two", "category": "math"},
        {"question_id": 1, "text": "Q one", "category": "common"}])
    ours = _jsonl(root / "ours.jsonl", [{"question_id": i, "text": f"o {i}"}
                                        for i in (1, 2)])
    base = _jsonl(root / "base.jsonl", [{"question_id": i, "text": f"b {i}"}
                                        for i in (1, 2)])
    rev = _jsonl(root / "rev.jsonl", [
        {"question_id": 1, "content": "7, 9\nAssistant 1 was terse.",
         "tuple": [7, 9]},
        {"question_id": 2, "content": "Assistant 2 hallucinated.",
         "tuple": [8, 4]}])
    return dict(root=root, tsv=str(tsv), sqa=str(sqa), mmhal=mmhal,
                objhal=objhal, qbench=str(qbench), generic_l=generic_l,
                generic_j=str(generic_j), pope_q=pope_q, pope_a=pope_a,
                pope_ann=str(ann), wq=wq, ours=ours, base=base, rev=rev)


def _mmbench_frame(m, fx, monkeypatch):
    """convert_mmbench_for_submission up to the xlsx write: the DataFrame
    it would write (openpyxl need not be installed)."""
    pd = pytest.importorskip("pandas")
    seen = {}
    monkeypatch.setattr(pd.DataFrame, "to_excel",
                        lambda self, path, **kw: seen.update(
                            frame=self.to_dict("list"), kw=kw))
    m.cv.convert_mmbench_for_submission(
        [{"question_id": 0, "text": "A"}, {"question_id": 2, "text": "C"}],
        fx["tsv"], str(fx["root"] / f"{m.side}.xlsx"))
    return seen


def _webpage_main(m, fx):
    out = fx["root"] / f"web_{m.side}.json"
    m.wd.main(["--questions", fx["wq"], "--ours", fx["ours"], "--answers",
               f"base={fx['base']}", "--reviews", f"base={fx['rev']}",
               "--output", str(out)])
    return out.read_text()


def _qa_baseline(m):
    def complete(text):
        if "boom" in text:
            raise RuntimeError("api down")
        return f"answer to: {text}"

    qs = [{"question_id": i, "text": f"q{i}"} for i in (3, 1, 2)]
    rows = m.gj.qa_baseline(qs, complete, max_workers=2, retries=1)
    return [{k: v for k, v in r.items() if k != "answer_id"} for r in rows]


def _sqa_examples(m):
    out = []
    for fmt in ("CQM-A", "QCML-AE", "QCMLE-ALE", "QCLEM-LEA", "QCEM-ELA"):
        fields = m.sp.problem_fields(SQA_PROBLEMS["q1"], True,
                                     m.sp.DEFAULT_OPTIONS)
        out.append([fields, m.sp.create_one_example(fmt, fields, True),
                    m.sp.create_one_example(fmt, fields, False),
                    m.sp.create_one_example_chatbot(fmt, fields, False),
                    m.sp.create_one_example_gpt4(fmt, fields, True)])
    return out


CASES = {
    # answer_normalize
    "normalize_vqa_answer": lambda m, fx: [m.an.normalize_vqa_answer(a) for a in (
        "Two", "a red car.", "It's blue!", "1,000", "dont", "ten  dogs?",
        "the 3.5 ft. pole", "yes/no", "isnt it")],
    "TextVQAAccuracy": lambda m, fx: m.an.TextVQAAccuracy().eval_pred_list([
        {"pred_answer": a, "gt_answers": ["cat"] * 4 + ["dog"] * 5 + ["a cat"]}
        for a in ("cat", "Dog.", "bird", "a cat")]),
    "anls_score": lambda m, fx: [m.an.anls_score(p, ["hello", "world"], t)
                                 for p in ("hello", "helo", "xyz", "World!")
                                 for t in (0.5, 0.2)],
    "anls_eval": lambda m, fx: m.an.anls_eval([
        {"pred_answer": "helo", "gt_answers": ["hello"]},
        {"pred_answer": "abc", "gt_answers": ["abd", "xyz"]}]),
    # scorers
    "score_pope": lambda m, fx: m.sc.score_pope(
        [{"text": t} for t in ("Yes, there is.", "No.", "There is not a dog.",
                               "Yes", "not sure")],
        ["yes", "no", "yes", "no", "yes"]),
    "score_pope_dir": lambda m, fx: m.sc.score_pope_dir(
        fx["pope_q"], fx["pope_a"], fx["pope_ann"]),
    "extract_sqa_answer": lambda m, fx: [m.sc.extract_sqa_answer(t) for t in (
        "B", "C. because of gravity", "Blah. The answer is D.", "no idea",
        "The answer is A. The answer is B.")],
    "score_science_qa": lambda m, fx: m.sc.score_science_qa(SQA_PROBLEMS,
                                                            SQA_PREDS),
    "score_sqa_vs_gpt4": lambda m, fx: m.sc.score_sqa_vs_gpt4(
        SQA_PROBLEMS, list(SQA_PROBLEMS), SQA_PREDS, GPT4),
    "score_sqa_requery": lambda m, fx: m.sc.score_sqa_requery(
        SQA_PROBLEMS, list(SQA_PROBLEMS), SQA_PREDS, GPT4, REQUERY),
    "textvqa_prompt_to_question": lambda m, fx: [
        m.sc.textvqa_prompt_to_question(p) for p in (
            "OCR tokens: a b Question: What is IT? Short answer:",
            "What is it?\nReference OCR token: x\nAnswer briefly.",
            "What is it?\nAnswer the question using a single word.")],
    "score_textvqa": lambda m, fx: m.sc.score_textvqa(
        [{"image_id": "img1", "question": "What is it?",
          "answers": ["cat"] * 10},
         {"image_id": "img2", "question": "Who?", "answers": ["bob"] * 3
          + ["alice"] * 7}],
        [{"question_id": "img1", "prompt": "What is it?\nAnswer briefly.",
          "text": "cat"},
         {"question_id": "img2", "prompt": "Who?\nAnswer briefly.",
          "text": "Bob"}]),
    "score_gqa": lambda m, fx: m.sc.score_gqa(GQA_QUESTIONS, GQA_PREDS),
    "score_mme": lambda m, fx: m.sc.score_mme(MME_ROWS),
    "mme_rows_from_answers": lambda m, fx: m.sc.mme_rows_from_answers(
        [{"question_id": "OCR/1.jpg-1", "text": "Yes, it is."},
         {"question_id": "OCR/1.jpg-2", "text": "no"}],
        [{"question_id": "OCR/1.jpg-1", "image": "1.jpg", "category": "OCR",
          "text": "Is it 'stop'?", "answer": "Yes"},
         {"question_id": "OCR/1.jpg-2", "image": "1.jpg", "category": "OCR",
          "text": "Is it 'go'?", "answer": "No"}]),
    "mme_task_lists": lambda m, fx: [m.sc.MME_PERCEPTION_TASKS,
                                     m.sc.MME_COGNITION_TASKS],
    # converters
    "convert_gqa_for_eval": lambda m, fx: m.cv.convert_gqa_for_eval(
        ANSWER_ROWS),
    "convert_vqav2_for_submission": lambda m, fx:
        m.cv.convert_vqav2_for_submission(
            ANSWER_ROWS, [{"question_id": "1"}, {"question_id": "3"},
                          {"question_id": "9"}]),
    "convert_vizwiz_for_submission": lambda m, fx:
        m.cv.convert_vizwiz_for_submission(
            ANSWER_ROWS, [{"question_id": "2", "image": "v.jpg"},
                          {"question_id": "3", "image": "w.jpg"}]),
    "convert_seed_for_submission": lambda m, fx:
        m.cv.convert_seed_for_submission(
            [{"question_id": "1", "text": "A"}, {"question_id": "2",
                                                 "text": "C"}],
            [{"question_id": "1", "question_type_id": 2, "answer": "A"},
             {"question_id": "2", "question_type_id": 3, "answer": "B"},
             {"question_id": "3", "question_type_id": 3, "answer": "D"}]),
    "convert_mmvet_for_eval": lambda m, fx: m.cv.convert_mmvet_for_eval(
        [{"question_id": "v1", "text": " An answer. "},
         {"question_id": "v2", "text": "B"}]),
    "convert_sqa_to_llava": lambda m, fx: m.cv.convert_sqa_to_llava(
        SQA_PROBLEMS, ["q1", "q2", "q3"]),
    # gqa_eval
    "score_gqa_full": lambda m, fx: m.gq.score_gqa_full(
        GQA_QUESTIONS, GQA_PREDS, choices=GQA_CHOICES),
    "score_gqa_full_no_choices": lambda m, fx: m.gq.score_gqa_full(
        GQA_QUESTIONS, GQA_PREDS, consistency=False),
    # sqa_prompt
    "sqa_examples": lambda m, fx: _sqa_examples(m),
    "sqa_build_prompt": lambda m, fx: [m.sp.build_prompt(
        SQA_PROBLEMS, ["q1", "q2"], "q3", fmt, use_caption=cap)
        for fmt in ("QCM-A", "CQM-ALE", "QCMLE-EA") for cap in (False, True)],
    "sqa_build_prompt_chatbot": lambda m, fx: [m.sp.build_prompt_chatbot(
        SQA_PROBLEMS, list(SQA_PROBLEMS), fmt, use_caption=False,
        is_test=test) for fmt in ("QCM-A", "QCM-LEPA", "QCM-ELA")
        for test in (False, True)],
    "sqa_build_prompt_gpt4": lambda m, fx: [m.sp.build_prompt_gpt4(
        SQA_PROBLEMS, ["q2", "q1"], "q3", fmt, use_caption=True)
        for fmt in ("QCM-A", "QCLEM-AEL")],
    # tasks
    "is_none": lambda m, fx: [m.tk.is_none(v) for v in (
        None, float("nan"), "nan", "None", "", "red", 0, 0.5)],
    "get_options": lambda m, fx: [m.tk.get_options(r) for r in (
        {"A": "x", "B": float("nan"), "C": "y"}, {"A": "x", "B": "y"},
        {"B": "y"})],
    "read_tsv": lambda m, fx: m.tk.read_tsv(fx["tsv"]),
    "mmbench_questions": lambda m, fx: m.tk.mmbench_questions(fx["tsv"]),
    "mmbench_all_rounds_cn": lambda m, fx: m.tk.mmbench_questions(
        fx["tsv"], all_rounds=True, lang="cn"),
    "mmbench_no_pred_prompt": lambda m, fx: m.tk.mmbench_questions(
        fx["tsv"], single_pred_prompt=False),
    "sqa_questions": lambda m, fx: [m.tk.sqa_questions(fx["sqa"]),
                                    m.tk.sqa_questions(
                                        fx["sqa"], single_pred_prompt=False)],
    "mmhal_questions": lambda m, fx: m.tk.mmhal_questions(
        fx["mmhal"], test_prompt=" Answer briefly."),
    "objhal_questions": lambda m, fx: m.tk.objhal_questions(fx["objhal"]),
    "qbench_questions": lambda m, fx: [m.tk.qbench_questions(fx["qbench"]),
                                       m.tk.qbench_questions(fx["qbench"],
                                                             lang="zh")],
    "generic_questions": lambda m, fx: [m.tk.generic_questions(
        fx["generic_l"]), m.tk.generic_questions(fx["generic_j"])],
    "TASKS": lambda m, fx: {name: fn(
        {"generic": fx["generic_l"], "mmbench": fx["tsv"], "sqa": fx["sqa"],
         "mmhal": fx["mmhal"], "objhal": fx["objhal"],
         "qbench": fx["qbench"]}[name]) for name, fn in m.tk.TASKS.items()},
    "task_prompts": lambda m, fx: [m.tk.ALL_OPTIONS, m.tk.SINGLE_PRED_EN,
                                   m.tk.SINGLE_PRED_CN],
    # gpt_judge
    "load_rubric": lambda m, fx: [m.gj.load_rubric(n) for n in (
        "mmhal_judge.txt", "objhal_extract.txt", "rule.json", "README.md")],
    "load_rules": lambda m, fx: m.gj.load_rules(),
    "build_review_content": lambda m, fx: [m.gj.build_review_content(
        REVIEW_QS[1], {"text": "a cat"}, {"text": "a dog"},
        m.gj.load_rules()[c], context=ctx)
        for c in ("conv", "detail") for ctx in (None, "a caption")],
    "review_context": lambda m, fx: [m.gj.review_context(
        REVIEW_QS[1], CONTEXTS, v) for v in ("default", "bench", "visual")],
    "parse_score_pair": lambda m, fx: [m.gj.parse_score_pair(r) for r in (
        "8 9\ngood", "7, 6.5\nfoo", "no scores here", "1 2 3", "")],
    "review_answers": lambda m, fx: m.gj.review_answers(
        REVIEW_QS, [{"answer_id": f"x{i}", "text": "a1"} for i in range(4)],
        [{"answer_id": f"y{i}", "text": "a2"} for i in range(4)],
        lambda c: f"{len(c) % 10} 6\nreasoning", contexts=CONTEXTS,
        variant="bench", rules={"llava_bench_conv": {"role": "Assistant",
                                                     "prompt": "judge!"},
                                "default": {"role": "Assistant",
                                            "prompt": "judge!"}}),
    "summarize_reviews": lambda m, fx: m.gj.summarize_reviews(
        [{"category": ["conv", "detail"][i % 2], "tuple": [8.0, 6.0 + i]}
         for i in range(5)] + [{"score": [1.0, 2.0]}]),
    "build_mmhal_prompt": lambda m, fx: m.gj.build_mmhal_prompt(
        {"image_content": ["Tree", "Dog"], "question": "What animal?",
         "gt_answer": "a dog", "model_answer": "a dog under a tree"}),
    "parse_mmhal_rating": lambda m, fx: [m.gj.parse_mmhal_rating(r) for r in (
        "analysis\nRating: 5, informative", "Rating: 2 ... rating: 4",
        "none")],
    "summarize_mmhal": lambda m, fx: m.gj.summarize_mmhal(
        [6, 5, 1, 0, 4, 3, 2, 6] * 2 + [3]),
    "build_objhal_extract_prompt": lambda m, fx:
        m.gj.build_objhal_extract_prompt("Describe.", "A dog and a tree."),
    "parse_object_list": lambda m, fx: [m.gj.parse_object_list(c) for c in (
        '["Dog", "Tree"]', "objects: dog, tree , car", "", "a\nb: x, y",
        '{"a": 1}')],
    "compute_chair": lambda m, fx: m.gj.compute_chair(CHAIR_RECORDS),
    "qa_baseline": lambda m, fx: _qa_baseline(m),
    "judge_system_prompt": lambda m, fx: m.gj.JUDGE_SYSTEM_PROMPT,
    # webpage_data
    "read_jsonl": lambda m, fx: [m.wd.read_jsonl(fx["wq"]),
                                 m.wd.read_jsonl(fx["wq"], key="question_id")],
    "clean_review": lambda m, fx: [m.wd.clean_review(t) for t in (
        "7, 9\nAssistant 1 was terse.", "Assistant 2 hallucinated.",
        "8 8\n\nBoth fine.")],
    "build_records": lambda m, fx: m.wd.build_records(
        m.wd.read_jsonl(fx["wq"], key="question_id"),
        m.wd.read_jsonl(fx["ours"], key="question_id"),
        {"base": m.wd.read_jsonl(fx["base"], key="question_id")},
        {"base": m.wd.read_jsonl(fx["rev"], key="question_id")}),
    "webpage_main": lambda m, fx: _webpage_main(m, fx),
    # the package's re-exports
    "eval_package_exports": lambda m, fx: sorted(
        n for n in vars(m.pkg) if not n.startswith("_")
        and not isinstance(getattr(m.pkg, n), types.ModuleType)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_copy_matches_jax(name, fx, capsys):
    want = CASES[name](JAX, fx)
    jprinted = capsys.readouterr().out
    got = CASES[name](PORT, fx)
    assert_same(got, want)
    assert (capsys.readouterr().out.replace("web_port", "web_jax")
            == jprinted)


def test_mmbench_converter_matches_jax(fx, monkeypatch):
    want = _mmbench_frame(JAX, fx, monkeypatch)
    got = _mmbench_frame(PORT, fx, monkeypatch)
    preds = got["frame"]["prediction"]
    assert preds[0] == "A" and preds[2] == "C"
    assert_same(got, want)


def test_data_files_live_in_the_port():
    """The rubrics and the webpage are the port's own copies, byte-equal to
    the JAX package's."""
    port_dir = os.path.dirname(t_gj.__file__)
    assert t_gj._RUBRIC_DIR == os.path.join(port_dir, "rubrics")
    for rel in ("rubrics/mmhal_judge.txt", "rubrics/objhal_extract.txt",
                "rubrics/rule.json", "rubrics/README.md"):
        with open(os.path.join(port_dir, rel), "rb") as a, open(
                os.path.join(os.path.dirname(j_gj.__file__), rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert os.path.exists(os.path.join(port_dir, "webpage", "index.html"))


# ---------------------------------------------------------------------------
# CHAIR repair
# ---------------------------------------------------------------------------

SYNONYMS = {"bicycle": ["bike", "bikes"], "motorcycle": ["motorbike"],
            "dog": ["puppy"], "person": ["man", "woman"]}
DOUBLE_WORDS = {"motor bike": "motorbike"}
REPAIR_RECORDS = [
    # bike -> bicycle and man -> person are in the ground truth; tree is
    # outside the vocabulary and is not a mention: 0 of 2 hallucinated
    {"pred_objects": ["bike", "man", "tree"], "gt_objects": ["bicycle",
                                                            "person"]},
    # 'motor bike' merges into motorbike -> motorcycle (hallucinated),
    # puppy -> dog and dog are right: 1 of 3
    {"pred_objects": ["motor bike", "puppy", "dog"], "gt_objects": ["dog"]},
    # bikes -> bicycle and woman -> person, against a motorbike: 2 of 2
    {"pred_objects": ["bikes", "woman"], "gt_objects": ["motorbike"]},
]


def test_chair_without_table_is_the_jax_metric():
    for records in (CHAIR_RECORDS, REPAIR_RECORDS):
        assert_same(t_gj.compute_chair(records), j_gj.compute_chair(records))
    raw = t_gj.compute_chair(REPAIR_RECORDS)
    assert raw["records"][0]["hallucinated"] == ["bike", "man", "tree"]


@pytest.mark.parametrize("as_list", [False, True])
def test_chair_with_synonyms_and_double_words(as_list):
    doubles = DOUBLE_WORDS
    synonyms = SYNONYMS
    if as_list:   # double words that stand for themselves, in the table
        doubles = ["motor bike"]
        synonyms = dict(SYNONYMS, motorcycle=["motorbike", "motor bike"])
    out = t_gj.compute_chair(REPAIR_RECORDS, synonyms=synonyms,
                             double_words=doubles)
    # CHAIRs: captions 2 and 3 hallucinate, of 3; CHAIRi: 0 + 1 + 2
    # hallucinated of 2 + 3 + 2 mentions
    assert out["CHAIRs"] == 2 / 3
    assert out["CHAIRi"] == 3 / 7
    assert [r["hallucinated"] for r in out["records"]] == [
        [], ["motorcycle"], ["bicycle", "person"]]
    assert [r["CHAIRi"] for r in out["records"]] == [0.0, 1 / 3, 1.0]


def test_chair_synonyms_without_double_words():
    """Without the double-word table 'motor bike' is two words: 'motor' is
    outside the vocabulary and 'bike' reads as a bicycle, so the caption
    hallucinates a bicycle instead of a motorcycle: 1 of 3 mentions."""
    out = t_gj.compute_chair(REPAIR_RECORDS[1:2], synonyms=SYNONYMS)
    assert out["CHAIRs"] == 1.0 and out["CHAIRi"] == 1 / 3
    assert out["records"][0]["hallucinated"] == ["bicycle"]
