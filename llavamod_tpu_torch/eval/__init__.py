from llavamod_tpu_torch.eval.answer_normalize import (
    normalize_vqa_answer,
    TextVQAAccuracy,
    anls_score,
)
from llavamod_tpu_torch.eval.scorers import (
    score_pope,
    score_science_qa,
    score_textvqa,
    score_gqa,
    score_mme,
)
