"""Aggregation metrics + bootstrap stderr (reference lm_eval/metrics.py)."""
from __future__ import annotations

import math
import random
from typing import List

import numpy as np


def mean(arr):
    return sum(arr) / len(arr)


def median(arr):
    return sorted(arr)[len(arr) // 2]


def perplexity(items):
    return math.exp(-mean(items))


def weighted_mean(items):
    a, b = zip(*items)
    return sum(a) / sum(b)


def weighted_perplexity(items):
    """items: [(loglikelihood, weight)] (reference lm_eval/metrics.py:103)."""
    return math.exp(-weighted_mean(items))


def bits_per_byte(items):
    return -weighted_mean(items) / math.log(2)


def matthews_corrcoef(items):
    golds, preds = zip(*items)
    tp = sum(1 for g, p in items if g == 1 and p == 1)
    tn = sum(1 for g, p in items if g == 0 and p == 0)
    fp = sum(1 for g, p in items if g == 0 and p == 1)
    fn = sum(1 for g, p in items if g == 1 and p == 0)
    denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return ((tp * tn) - (fp * fn)) / denom if denom else 0.0


def f1_score(items):
    golds, preds = zip(*items)
    tp = sum(1 for g, p in items if g == 1 and p == 1)
    fp = sum(1 for g, p in items if g == 0 and p == 1)
    fn = sum(1 for g, p in items if g == 1 and p == 0)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    return 2 * prec * rec / (prec + rec) if prec + rec else 0.0


def yesno(x):
    return "yes" if x else "no"


def acc_all(items):
    """MultiRC grouped accuracy: a question counts only if every candidate
    answer is classified correctly (reference lm_eval/metrics.py:48-64)."""
    question_scoring = {}
    for pred, doc in items:
        key = (doc["idx"]["paragraph"], doc["idx"]["question"])
        question_scoring.setdefault(key, []).append(
            (doc["label"] == 1) == pred)
    return float(np.mean([int(all(v)) for v in question_scoring.values()]))


def metric_max_over_ground_truths(metric_fn, prediction, ground_truths):
    return max(metric_fn(prediction, gt) for gt in ground_truths)


# -- SQuAD-style normalized exact/F1 (the reference imports these from
# transformers.data.metrics.squad_metrics; re-derived here to keep the
# harness importable without the torch stack) -------------------------------

def normalize_answer(s: str) -> str:
    import re as _re
    import string as _string

    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(_string.punctuation))
    s = _re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def compute_exact(a_gold: str, a_pred: str) -> int:
    return int(normalize_answer(a_gold) == normalize_answer(a_pred))


def compute_f1(a_gold: str, a_pred: str) -> float:
    import collections

    gold_toks = normalize_answer(a_gold).split()
    pred_toks = normalize_answer(a_pred).split()
    common = collections.Counter(gold_toks) & collections.Counter(pred_toks)
    num_same = sum(common.values())
    if len(gold_toks) == 0 or len(pred_toks) == 0:
        return float(gold_toks == pred_toks)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


# -- corpus translation metrics (sacrebleu-backed, as in the reference
# lm_eval/metrics.py:111-154) ------------------------------------------------

def _sacreformat(refs, preds):
    """Format refs/preds to the [[ref1...], [ref2...]] x [pred...] shape
    sacrebleu's corpus functions expect (reference lm_eval/metrics.py:161-187)."""
    def is_iter(x):
        return hasattr(x, "__iter__") and not isinstance(x, str)

    if not is_iter(refs):
        refs = list(refs)
    if not is_iter(refs[0]):
        refs = [[ref] for ref in refs]
    refs = list(zip(*refs))
    if not is_iter(preds):
        preds = list(preds)
    if is_iter(preds[0]):
        assert len(preds[0]) == 1
        preds = [pred[0] for pred in preds]
    return refs, preds


def bleu(items):
    import sacrebleu

    refs, preds = _sacreformat(*zip(*items))
    return sacrebleu.corpus_bleu(preds, refs).score


def chrf(items):
    import sacrebleu

    refs, preds = _sacreformat(*zip(*items))
    return sacrebleu.corpus_chrf(preds, refs).score


def ter(items):
    import sacrebleu

    refs, preds = _sacreformat(*zip(*items))
    return sacrebleu.corpus_ter(preds, refs).score


def bootstrap_stderr(fn, xs, iters: int = 1000):
    """Single-process bootstrap (the reference parallelizes over a pool,
    lm_eval/metrics.py:207-233; iters kept modest instead)."""
    rnd = random.Random(1234)
    res = []
    n = len(xs)
    for _ in range(iters):
        sample = [xs[rnd.randrange(n)] for _ in range(n)]
        res.append(fn(sample))
    return float(np.std(res))


def stderr_for_metric(metric, bootstrap_iters: int = 1000):
    if metric is mean or metric == mean:
        def _mean_stderr(xs):
            if len(xs) <= 1:
                return 0.0
            return float(np.std(xs, ddof=1) / math.sqrt(len(xs)))
        return _mean_stderr
    bootstrappable = {median, matthews_corrcoef, f1_score,
                      weighted_perplexity, bits_per_byte, perplexity,
                      bleu, chrf, ter}
    if metric in bootstrappable:
        return lambda xs: bootstrap_stderr(metric, xs, bootstrap_iters)
    return None
