"""VQA accuracy under the official protocol (the port's copy of
efficientvlm_tpu/evaluation/vqa.py, after the reference's
vqaTools/vqaEval.py): the predicted answer has its punctuation, digits,
articles and contractions normalised; per question, each of the 10
annotators is left out in turn and the answer scores min(#others that
match / 3, 1); the question's accuracy is the mean of the 10.
"""

from __future__ import annotations

import re
from typing import Dict, List

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "im": "i'm", "ive": "i've", "isnt": "isn't", "itd": "it'd", "itll": "it'll",
    "lets": "let's", "mightve": "might've", "mustve": "must've", "shant": "shan't",
    "shed": "she'd", "shes": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "somebodyd": "somebody'd", "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingll": "something'll", "thats": "that's",
    "thered": "there'd", "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "yall": "y'all", "youd": "you'd",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}
DIGIT_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}
ARTICLES = {"a", "an", "the"}
PUNCT = list(";/[]\"{}()=+\\_-><@`,?!")
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or COMMA_STRIP.search(text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = PERIOD_STRIP.sub("", out)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = DIGIT_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def _question_acc(res_ans: str, gt_answers: List[str]) -> float:
    """Official per-question accuracy (vqaTools/vqaEval.py:85-104): the
    RESULT answer gets punctuation + digit/article processing; gt answers
    get ONLY punctuation processing, and only when the annotator set is
    non-unanimous (len(set)>1); leave-one-out min(#matching/3, 1) average.
    (Normalizing gts fully would flip matches like gt 'two' vs res '2'.)"""
    res_ans = normalize_answer(res_ans)
    if len(set(gt_answers)) > 1:
        gt_answers = [process_punctuation(a) for a in gt_answers]
    per_annotator = []
    for i in range(len(gt_answers)):
        others = gt_answers[:i] + gt_answers[i + 1:]
        matching = sum(1 for o in others if o == res_ans)
        per_annotator.append(min(1.0, matching / 3.0))
    return sum(per_annotator) / len(per_annotator)


def vqa_accuracy(results: List[dict], annotations: Dict[int, List[str]]) -> float:
    """results: [{'question_id', 'answer'}]; annotations: qid -> 10 answers.
    Overall accuracy under the official protocol."""
    accs = [
        _question_acc(r["answer"], annotations[r["question_id"]])
        for r in results if r["question_id"] in annotations
    ]
    return 100.0 * sum(accs) / max(len(accs), 1)


def vqa_accuracy_breakdown(
    results: List[dict],
    annotations: Dict[int, List[str]],
    question_types: Dict[int, str] | None = None,
    answer_types: Dict[int, str] | None = None,
    *,
    n: int = 2,
) -> dict:
    """Full official accuracy dict (vqaTools/vqaEval.py:68-152):
    {'overall', 'perQuestionType', 'perAnswerType', 'evalQA'} with the
    reference's 2-decimal rounding. question_types / answer_types map
    qid -> type (the reference reads them off the annotation records)."""
    acc_qa, eval_qa = [], {}
    acc_qt: Dict[str, list] = {}
    acc_at: Dict[str, list] = {}
    for r in results:
        qid = r["question_id"]
        if qid not in annotations:
            continue
        acc = _question_acc(r["answer"], annotations[qid])
        acc_qa.append(acc)
        eval_qa[qid] = round(100.0 * acc, n)
        if question_types and qid in question_types:
            acc_qt.setdefault(question_types[qid], []).append(acc)
        if answer_types and qid in answer_types:
            acc_at.setdefault(answer_types[qid], []).append(acc)
    return {
        "overall": round(100.0 * sum(acc_qa) / max(len(acc_qa), 1), n),
        "perQuestionType": {k: round(100.0 * sum(v) / len(v), n)
                            for k, v in acc_qt.items()},
        "perAnswerType": {k: round(100.0 * sum(v) / len(v), n)
                          for k, v in acc_at.items()},
        "evalQA": eval_qa,
    }
