"""GLUE + SuperGLUE tasks (reference lm_eval/tasks/glue.py and
lm_eval/tasks/superglue.py). Prompt strings and scoring rules match the
reference so accuracies are comparable; RTE/SST/BoolQ/COPA live in tasks.py.
"""
from __future__ import annotations

import numpy as np

from .base import Task, rf
from .metrics import (
    acc_all, compute_exact, compute_f1, f1_score, matthews_corrcoef, mean,
    metric_max_over_ground_truths, yesno)


def general_detokenize(string):
    """reference lm_eval/utils.py:62-69."""
    import re

    string = string.replace(" n't", "n't")
    string = string.replace(" )", ")")
    string = string.replace("( ", "(")
    string = string.replace('" ', '"')
    string = string.replace(' "', '"')
    string = re.sub(r" (['.,])", r"\1", string)
    return string


class _GlueTask(Task):
    DATASET_PATH = "glue"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.data["train"])
        return self._training_docs

    def validation_docs(self):
        return self.data["validation"]

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class CoLA(_GlueTask):
    """reference lm_eval/tasks/glue.py CoLA — Matthews correlation."""

    DATASET_NAME = "cola"

    def doc_to_text(self, doc):
        return "{}\nQuestion: Does this sentence make sense?\nAnswer:".format(
            doc["sentence"])

    def doc_to_target(self, doc):
        return " {}".format({1: "yes", 0: "no"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_true, ll_false = results
        return {"mcc": (doc["label"], int(ll_true > ll_false))}

    def aggregation(self):
        return {"mcc": matthews_corrcoef}

    def higher_is_better(self):
        return {"mcc": True}


class MNLI(_GlueTask):
    DATASET_NAME = "mnli"

    def validation_docs(self):
        return self.data["validation_matched"]

    def doc_to_text(self, doc):
        hyp = doc["hypothesis"].strip()
        return "{}\nQuestion: {} True, False or Neither?\nAnswer:".format(
            doc["premise"], hyp + ("" if hyp.endswith(".") else "."))

    def doc_to_target(self, doc):
        # 0 entailment / 1 neutral / 2 contradiction
        return " {}".format({0: "True", 1: "Neither", 2: "False"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " True")[0],
                rf.loglikelihood(ctx, " Neither")[0],
                rf.loglikelihood(ctx, " False")[0]]

    def process_results(self, doc, results):
        return {"acc": float(np.argmax(results) == doc["label"])}


class MNLIMismatched(MNLI):
    def validation_docs(self):
        return self.data["validation_mismatched"]


class QNLI(_GlueTask):
    DATASET_NAME = "qnli"

    def doc_to_text(self, doc):
        return ("{}\n{}\nQuestion: Does this response answer the question?"
                "\nAnswer:".format(doc["question"], doc["sentence"]))

    def doc_to_target(self, doc):
        return " {}".format({0: "yes", 1: "no"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": float(int(ll_no > ll_yes) == doc["label"])}


class WNLI(_GlueTask):
    VERSION = 1
    DATASET_NAME = "wnli"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {} True or False?\nAnswer:".format(
            doc["sentence1"], doc["sentence2"])

    def doc_to_target(self, doc):
        return " {}".format({0: "False", 1: "True"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " True")[0],
                rf.loglikelihood(ctx, " False")[0]]

    def process_results(self, doc, results):
        ll_true, ll_false = results
        return {"acc": float(int(ll_true > ll_false) == doc["label"])}


class MRPC(_GlueTask):
    DATASET_NAME = "mrpc"

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Do both sentences "
                "mean the same thing?\nAnswer:".format(
                    general_detokenize(doc["sentence1"]),
                    general_detokenize(doc["sentence2"])))

    def doc_to_target(self, doc):
        return " {}".format(yesno(doc["label"]))

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        pred = int(ll_yes > ll_no)
        return {"acc": float(pred == doc["label"]),
                "f1": (doc["label"], pred)}

    def aggregation(self):
        return {"acc": mean, "f1": f1_score}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class QQP(MRPC):
    DATASET_NAME = "qqp"

    def doc_to_text(self, doc):
        return ("Question 1: {}\nQuestion 2: {}\nQuestion: Do both questions "
                "ask the same thing?\nAnswer:".format(
                    doc["question1"], doc["question2"]))


# ---------------------------------------------------------------------------
# SuperGLUE (cb / wic / wsc / multirc / record)
# ---------------------------------------------------------------------------

class CommitmentBank(_GlueTask):
    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "cb"

    def doc_to_text(self, doc):
        return "{}\nQuestion: {}. True, False or Neither?\nAnswer:".format(
            doc["premise"], doc["hypothesis"])

    def doc_to_target(self, doc):
        # 0 entailment / 1 contradiction / 2 neutral
        return " {}".format({0: "True", 1: "False", 2: "Neither"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " True")[0],
                rf.loglikelihood(ctx, " False")[0],
                rf.loglikelihood(ctx, " Neither")[0]]

    def process_results(self, doc, results):
        pred = int(np.argmax(results))
        return {"acc": float(pred == doc["label"]),
                "f1": (pred, doc["label"])}

    @classmethod
    def cb_multi_fi(cls, items):
        """Per-class F1 averaged over the 3 classes
        (reference superglue.py:149-157), sklearn-free."""
        preds, golds = zip(*items)
        preds, golds = np.array(preds), np.array(golds)

        def f1_for(c):
            return f1_score(list(zip(
                (golds == c).astype(int), (preds == c).astype(int))))

        return mean([f1_for(0), f1_for(1), f1_for(2)])

    def aggregation(self):
        return {"acc": mean, "f1": self.cb_multi_fi}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class WordsInContext(_GlueTask):
    DATASET_PATH = "super_glue"
    DATASET_NAME = "wic"

    def doc_to_text(self, doc):
        return ("Sentence 1: {}\nSentence 2: {}\nQuestion: Is the word '{}' "
                "used in the same way in the two sentences above?\nAnswer:"
                .format(doc["sentence1"], doc["sentence2"],
                        doc["sentence1"][doc["start1"]:doc["end1"]]))

    def doc_to_target(self, doc):
        return " {}".format({0: "no", 1: "yes"}[doc["label"]])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": float(int(ll_yes > ll_no) == doc["label"])}


class SGWinogradSchemaChallenge(_GlueTask):
    """SuperGLUE WSC, the binary pronoun-reference variant."""

    DATASET_PATH = "super_glue"
    DATASET_NAME = "wsc"

    def training_docs(self):
        if self._training_docs is None:
            # GPT-3 format: fewshot pool is positive examples only
            self._training_docs = [
                d for d in self.data["train"] if d["label"]]
        return self._training_docs

    def doc_to_text(self, doc):
        raw = doc["text"]
        pre = " ".join(raw.split()[: doc["span2_index"]])
        post = raw[len(pre) + len(doc["span2_text"]) + 1:]
        passage = general_detokenize(
            pre + " *{}*".format(doc["span2_text"]) + post)
        return (
            f"Passage: {passage}\n"
            f'Question: In the passage above, does the pronoun '
            f'"*{doc["span2_text"]}*" refer to "*{doc["span1_text"]}*"?\n'
            "Answer:")

    def doc_to_target(self, doc):
        return " " + yesno(doc["label"])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": float(int(ll_yes > ll_no) == doc["label"])}


class MultiRC(_GlueTask):
    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "multirc"

    def doc_to_text(self, doc):
        return f"{doc['paragraph']}\nQuestion: {doc['question']}\nAnswer:"

    @staticmethod
    def format_answer(answer, label):
        return f"{answer}\nIs the answer correct? {'yes' if label else 'no'}"

    def doc_to_target(self, doc):
        return " " + self.format_answer(doc["answer"], doc["label"])

    def construct_requests(self, doc, ctx):
        t = self.format_answer(doc["answer"], True)
        f = self.format_answer(doc["answer"], False)
        return [rf.loglikelihood(ctx, f" {t}")[0],
                rf.loglikelihood(ctx, f" {f}")[0]]

    def process_results(self, doc, results):
        ll_true, ll_false = results
        return {"acc": (ll_true > ll_false, doc)}

    def aggregation(self):
        return {"acc": acc_all}


class ReCoRD(_GlueTask):
    DATASET_PATH = "super_glue"
    DATASET_NAME = "record"

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.data["train"]]
        return self._training_docs

    def validation_docs(self):
        for doc in self.data["validation"]:
            yield self._process_doc(doc)

    @classmethod
    def _process_doc(cls, doc):
        return {
            "passage": doc["passage"],
            "query": doc["query"],
            "entities": sorted(set(doc["entities"])),
            "answers": sorted(set(doc["answers"])),
        }

    def doc_to_text(self, doc):
        initial_text, *highlights = doc["passage"].strip().split(
            "\n@highlight\n")
        text = initial_text + "\n\n"
        for highlight in highlights:
            text += f"  - {highlight}.\n"
        return text

    @classmethod
    def format_answer(cls, query, entity):
        return f"  - {query}".replace("@placeholder", entity)

    def doc_to_target(self, doc):
        return self.format_answer(doc["query"], doc["answers"][0])

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, self.format_answer(doc["query"], entity))
            for entity in doc["entities"]
        ]

    def process_results(self, doc, results):
        max_idx = int(np.argmax([r[0] for r in results]))
        prediction = doc["entities"][max_idx]
        gold = doc["answers"]
        return {
            "f1": metric_max_over_ground_truths(compute_f1, prediction, gold),
            "em": metric_max_over_ground_truths(
                compute_exact, prediction, gold),
        }

    def aggregation(self):
        return {"f1": mean, "em": mean}

    def higher_is_better(self):
        return {"f1": True, "em": True}


GLUE_TASKS = {
    "cola": CoLA,
    "mnli": MNLI,
    "mnli_mismatched": MNLIMismatched,
    "mrpc": MRPC,
    "qnli": QNLI,
    "qqp": QQP,
    "wnli": WNLI,
    "cb": CommitmentBank,
    "wic": WordsInContext,
    "wsc": SGWinogradSchemaChallenge,
    "multirc": MultiRC,
    "record": ReCoRD,
}
