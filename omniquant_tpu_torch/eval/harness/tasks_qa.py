"""QA / reading-comprehension / commonsense tasks (reference modules:
lm_eval/tasks/{anli,swag,webqs,logiqa,mathqa,race,wsc273,headqa,pubmedqa,
qa4mre,prost,mc_taco,mutual}.py). Prompt strings and scoring rules match the
reference so accuracies are comparable; data is injected offline or loaded
from HF datasets by path."""
from __future__ import annotations

import collections

import numpy as np

from .base import MultipleChoiceTask, Task, rf
from .metrics import mean


class ANLIBase(Task):
    """reference anli.py:33-129 — 3-way NLI with True/Neither/False verbalizers."""

    DATASET_PATH = "anli"
    ROUND = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.data[f"train_r{self.ROUND}"])
        return self._training_docs

    def validation_docs(self):
        return self.data[f"dev_r{self.ROUND}"]

    def test_docs(self):
        return self.data[f"test_r{self.ROUND}"]

    def doc_to_text(self, doc):
        return (doc["premise"] + "\nQuestion: " + doc["hypothesis"]
                + " True, False, or Neither?\nAnswer:")

    def doc_to_target(self, doc):
        # label: 0 entailment / 1 neutral / 2 contradiction
        return " " + ["True", "Neither", "False"][doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " True")[0],
                rf.loglikelihood(ctx, " Neither")[0],
                rf.loglikelihood(ctx, " False")[0]]

    def process_results(self, doc, results):
        return {"acc": float(np.argmax(results) == doc["label"])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class ANLIRound1(ANLIBase):
    ROUND = 1


class ANLIRound2(ANLIBase):
    ROUND = 2


class ANLIRound3(ANLIBase):
    ROUND = 3


class SWAG(MultipleChoiceTask):
    """reference swag.py:31-59."""

    DATASET_PATH = "swag"
    DATASET_NAME = "regular"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.data["train"]]
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.data["validation"])

    def _process_doc(self, doc):
        return {
            "query": doc["startphrase"],
            "choices": [doc["ending0"], doc["ending1"],
                        doc["ending2"], doc["ending3"]],
            "gold": int(doc["label"]),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class WebQs(Task):
    """reference webqs.py:36-98 — correct if ANY answer alias is greedily
    completed; prefix-deduped alias list."""

    DATASET_PATH = "web_questions"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.data["train"])
        return self._training_docs

    def test_docs(self):
        return self.data["test"]

    def doc_to_text(self, doc):
        return "Question: " + doc["question"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["answers"][0]

    @staticmethod
    def _remove_prefixes(aliases):
        aliases = sorted(aliases)
        kept = [aliases[0]]
        for alias in aliases[1:]:
            if not alias.startswith(kept[-1]):
                kept.append(alias)
        return kept

    def construct_requests(self, doc, ctx):
        # [1] = the is-greedy bit of the loglikelihood request
        return [rf.loglikelihood(ctx, " " + alias)[1]
                for alias in self._remove_prefixes(doc["answers"])]

    def process_results(self, doc, results):
        return {"acc": float(any(results))}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class LogiQA(MultipleChoiceTask):
    """reference logiqa.py:31-89 (local txt builder in the reference; plain
    rows with context/question/options/label here)."""

    DATASET_PATH = "lucasmccabe/logiqa"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.data["train"]]
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.data["validation"])

    def test_docs(self):
        return map(self._process_doc, self.data["test"])

    def _process_doc(self, doc):
        letters = ["a", "b", "c", "d"]
        prompt = "Passage: " + doc["context"] + "\n"
        prompt += "Question: " + doc["question"] + "\nChoices:\n"
        for letter, option in zip(letters, doc["options"]):
            prompt += f"{letter.upper()}. {option}\n"
        prompt += "Answer:"
        label = doc["label"]
        gold = letters.index(label) if isinstance(label, str) else int(label)
        return {"query": prompt, "choices": doc["options"], "gold": gold}

    def doc_to_text(self, doc):
        return doc["query"]


class MathQA(MultipleChoiceTask):
    """reference mathqa.py:28-73 — options parsed out of the 'a ) ... , e ) ...'
    string."""

    DATASET_PATH = "math_qa"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.data["train"]]
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.data["validation"])

    def test_docs(self):
        return map(self._process_doc, self.data["test"])

    def _process_doc(self, doc):
        import re

        gold = ["a", "b", "c", "d", "e"].index(doc["correct"])
        choices = [
            c[4:].rstrip(" ,")
            for c in re.findall(r"[abcd] \) .*?, |e \) .*?$", doc["options"])
        ]
        return {
            "query": "Question: " + doc["Problem"] + "\nAnswer:",
            "choices": choices,
            "gold": gold,
        }

    def doc_to_text(self, doc):
        return doc["query"]


class RACE(Task):
    """reference race.py:36-173 — questions grouped per article; earlier
    questions of the same article appear answered in the prompt."""

    VERSION = 1
    DATASET_PATH = "race"
    DATASET_NAME = "high"

    letter_to_num = {"A": 0, "B": 1, "C": 2, "D": 3}

    def __init__(self, data=None):
        super().__init__(data)
        self._collated = {}

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def _collate(self, split):
        if split not in self._collated:
            by_article = collections.defaultdict(list)
            for item in self.data[split]:
                by_article[item["article"]].append({
                    "question": item["question"],
                    "answer": item["answer"],
                    "options": item["options"],
                })
            self._collated[split] = [
                {"article": article, "problems": problems}
                for article, problems in by_article.items()
            ]
        return self._collated[split]

    def training_docs(self):
        return self._collate("train")

    def validation_docs(self):
        return self._collate("validation")

    def test_docs(self):
        return self._collate("test")

    @classmethod
    def _answer_option(cls, problem):
        return problem["options"][cls.letter_to_num[problem["answer"]]]

    def doc_to_text(self, doc):
        text = "Article: " + doc["article"] + "\n\n"
        for problem in doc["problems"][:-1]:
            if problem["question"][-6:] == "  _  .":
                text += (problem["question"][-5:]
                         + self._answer_option(problem) + "\n")
            else:
                text += ("Question: " + problem["question"] + "\n"
                         + "Answer: " + self._answer_option(problem) + "\n")
        text += doc["problems"][-1]["question"]
        return text

    def doc_to_target(self, doc):
        return " " + self._answer_option(doc["problems"][-1])

    def construct_requests(self, doc, ctx):
        problem = doc["problems"][-1]
        return [rf.loglikelihood(ctx, " " + problem["options"][i])[0]
                for i in range(4)]

    def process_results(self, doc, results):
        gold = self.letter_to_num[doc["problems"][-1]["answer"]]
        return {"acc": float(np.argmax(results) == gold)}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class WinogradSchemaChallenge273(Task):
    """reference wsc273.py:33-171 — partial evaluation: score the sentence
    continuation after substituting each candidate for the pronoun."""

    DATASET_PATH = "winograd_wsc"
    DATASET_NAME = "wsc273"

    upper_pronouns = ["A", "An", "The", "She", "He", "It", "They", "My",
                      "His", "Her", "Their"]

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.data["test"])

    def _process_doc(self, doc):
        doc = dict(doc)
        doc["text"] = doc["text"].replace("  ", " ")
        doc["options"] = [self._normalize_option(doc, o)
                          for o in doc["options"]]
        return doc

    def _normalize_option(self, doc, option):
        if doc["pronoun"].lower() in ("my", "his", "her", "our", "their"):
            option += "'s"
        pronoun = option.split()[0]
        start_of_sentence = doc["text"][doc["pronoun_loc"] - 2] == "."
        if not start_of_sentence and pronoun in self.upper_pronouns:
            return option.replace(pronoun, pronoun.lower())
        return option

    @staticmethod
    def partial_context(doc, option):
        return doc["text"][: doc["pronoun_loc"]] + option

    @staticmethod
    def partial_target(doc):
        start = doc["pronoun_loc"] + len(doc["pronoun"])
        return " " + doc["text"][start:].strip()

    def doc_to_text(self, doc):
        return self.partial_context(doc, doc["options"][doc["label"]])

    def doc_to_target(self, doc):
        return self.partial_target(doc)

    @staticmethod
    def append_context(ctx, partial_ctx):
        parts = ctx.split("\n\n")
        parts.pop()  # drop the doc_to_text context fewshot_context added
        return "\n\n".join([*parts, partial_ctx]) if parts else partial_ctx

    def construct_requests(self, doc, ctx):
        target = self.partial_target(doc)
        return [
            rf.loglikelihood(
                self.append_context(ctx, self.partial_context(doc, option)),
                target)[0]
            for option in doc["options"]
        ]

    def process_results(self, doc, results):
        return {"acc": float(np.argmax(results) == doc["label"])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class HeadQABase(MultipleChoiceTask):
    """reference headqa.py:34-76 (local builder in the reference; HF rows
    with qtext/answers/ra here)."""

    DATASET_PATH = "head_qa"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.data["train"]]
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.data["validation"])

    def test_docs(self):
        return map(self._process_doc, self.data["test"])

    def _process_doc(self, doc):
        return {
            "query": "Question: " + doc["qtext"] + "\nAnswer:",
            "choices": [a["atext"] for a in doc["answers"]],
            "gold": int(doc["ra"]) - 1,
        }

    def doc_to_text(self, doc):
        return doc["query"]


class HeadQAEn(HeadQABase):
    DATASET_NAME = "en"


class HeadQAEs(HeadQABase):
    DATASET_NAME = "es"


class PubmedQA(Task):
    """reference pubmedqa.py:30-89 — yes/no/maybe over abstracts; HF 'train'
    split is the labeled test set."""

    DATASET_PATH = "pubmed_qa"
    DATASET_NAME = "pqa_labeled"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return self.data["train"]

    def doc_to_text(self, doc):
        ctxs = "\n".join(doc["context"]["contexts"])
        return "Abstract: {}\nQuestion: {}\nAnswer:".format(
            ctxs, doc["question"])

    def doc_to_target(self, doc):
        return " {}".format(doc["final_decision"])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0],
                rf.loglikelihood(ctx, " maybe")[0]]

    def process_results(self, doc, results):
        pred = ["yes", "no", "maybe"][int(np.argmax(results))]
        return {"acc": float(pred == doc["final_decision"])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class QA4MRE(MultipleChoiceTask):
    """reference qa4mre.py:28-63 — only a 'train' split exists, used as test."""

    DATASET_PATH = "qa4mre"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.data["train"])

    def _process_doc(self, doc):
        return {
            "source": doc["document_str"].strip().replace("'", "'"),
            "query": doc["question_str"],
            "choices": doc["answer_options"]["answer_str"],
            "gold": int(doc["correct_answer_id"]) - 1,
        }

    def doc_to_text(self, doc):
        return "{}\nQuestion: {}\nAnswer:".format(doc["source"], doc["query"])


class QA4MRE_2011(QA4MRE):
    DATASET_NAME = "2011.main.EN"


class QA4MRE_2012(QA4MRE):
    DATASET_NAME = "2012.main.EN"


class QA4MRE_2013(QA4MRE):
    DATASET_NAME = "2013.main.EN"


class PROST(MultipleChoiceTask):
    """reference prost.py:29-80 — zero-shot only physical-reasoning probe."""

    DATASET_PATH = "corypaik/prost"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.data["test"])

    def fewshot_context(self, doc, num_fewshot, rnd):
        assert num_fewshot == 0, "PROST is zero-shot only"
        return super().fewshot_context(doc, num_fewshot, rnd)

    def _process_doc(self, doc):
        return {
            "query": (f"{doc['context']}\nQuestion: {doc['ex_question']}"
                      "\nAnswer:"),
            "choices": [doc["A"], doc["B"], doc["C"], doc["D"]],
            "gold": doc["label"],
        }

    def doc_to_text(self, doc):
        return doc["query"]


class MCTACO(Task):
    """reference mc_taco.py:31-149 — per-question grouped EM and F1 over
    plausibility yes/no decisions."""

    DATASET_PATH = "mc_taco"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return self.data["validation"]

    def test_docs(self):
        return self.data["test"]

    def doc_to_text(self, doc):
        return (f"{doc['sentence']}\nQuestion: {doc['question']}\n"
                f"Answer: {doc['answer']}\nPlausible:")

    def doc_to_target(self, doc):
        return " " + ["no", "yes"][doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " no")[0],
                rf.loglikelihood(ctx, " yes")[0]]

    def process_results(self, doc, results):
        ll_no, ll_yes = results
        pred = int(ll_yes > ll_no)
        qid = " ".join([doc["sentence"], doc["question"]])
        items = (doc["label"], pred, qid)
        return {"em": items, "f1": items}

    @staticmethod
    def _exact_match(items):
        per_question = collections.defaultdict(list)
        for gold, pred, qid in items:
            per_question[qid].append(pred == gold)
        return float(np.mean(
            [int(all(v)) for v in per_question.values()]))

    @staticmethod
    def _f1(items):
        gold_pos = collections.defaultdict(list)
        pred_pos = collections.defaultdict(list)
        for gold, pred, qid in items:
            gold_pos[qid].append(gold)
            pred_pos[qid].append(pred)
        scores = []
        for qid in gold_pos:
            gp, pp = sum(gold_pos[qid]), sum(pred_pos[qid])
            tp = sum(np.logical_and(gold_pos[qid], pred_pos[qid]))
            p = tp / pp if pp > 0.0 else 1.0
            r = tp / gp if gp > 0.0 else 1.0
            if p + r > 0.0:
                scores.append(2.0 * p * r / (p + r))
        return float(np.mean(scores)) if scores else 0.0

    def aggregation(self):
        return {"em": self._exact_match, "f1": self._f1}

    def higher_is_better(self):
        return {"em": True, "f1": True}


class MuTualBase(Task):
    """reference mutual.py:33-106 — dialogue next-turn ranking with
    r@1 / r@2 / mrr."""

    VERSION = 1
    DATASET_PATH = "mutual"
    CHOICES = ["A", "B", "C", "D"]

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        return self.data["train"]

    def validation_docs(self):
        return self.data["validation"]

    @staticmethod
    def detokenize(text):
        for a, b in ((" '", "'"), (" \n", "\n"), ("\n ", "\n"),
                     (" n't", "n't"), ("`` ", '"'), ("''", '"'),
                     (" :", ":"), (" ;", ";"), (" !", "!"), (" ?", "?"),
                     (" ,", ","), (" .", ".")):
            text = text.replace(a, b)
        return text

    def doc_to_text(self, doc):
        return self.detokenize(doc["article"])

    def doc_to_target(self, doc):
        return " " + self.detokenize(
            doc["options"][self.CHOICES.index(doc["answers"])])

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, f" {self.detokenize(option)}")[0]
                for option in doc["options"]]

    def process_results(self, doc, results):
        gold = self.CHOICES.index(doc["answers"])
        r4_1 = float(np.argmax(results) == gold)
        ranks = sorted(results, reverse=True)
        r4_2 = float(ranks.index(results[gold]) == 1) + r4_1
        mrr = 1.0 / (ranks.index(results[gold]) + 1)
        return {"r@1": r4_1, "r@2": r4_2, "mrr": mrr}

    def aggregation(self):
        return {"r@1": mean, "r@2": mean, "mrr": mean}

    def higher_is_better(self):
        return {"r@1": True, "r@2": True, "mrr": True}


class MuTual(MuTualBase):
    DATASET_NAME = "mutual"


class MuTualPlus(MuTualBase):
    DATASET_NAME = "mutual_plus"


class QASPER(Task):
    """reference qasper.py — QA over NLP-paper abstracts; yes/no questions
    scored by loglikelihood F1, free-form by token F1; extractive spans are
    skipped (as in the reference)."""

    DATASET_PATH = "qasper"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    @staticmethod
    def _categorise(answer_blob):
        if answer_blob["unanswerable"]:
            return "unanswerable", "unanswerable"
        if answer_blob["yes_no"]:
            return "yes", "bool"
        if answer_blob["free_form_answer"]:
            return answer_blob["free_form_answer"], "free form answer"
        if answer_blob["extractive_spans"]:
            return answer_blob["extractive_spans"], "extractive_spans"
        if answer_blob["yes_no"] is False:
            return "no", "bool"
        return None, None

    def _process_doc(self, doc):
        for question, answer_list in zip(doc["qas"]["question"],
                                         doc["qas"]["answers"]):
            for answer_blob in answer_list["answer"]:
                answer, answer_type = self._categorise(answer_blob)
                yield {
                    "title": doc["title"],
                    "abstract": doc["abstract"],
                    "question": question,
                    "answer": answer,
                    "answer_type": answer_type,
                }

    def training_docs(self):
        for doc in self.data["train"]:
            yield from self._process_doc(doc)

    def validation_docs(self):
        for doc in self.data["validation"]:
            yield from self._process_doc(doc)

    def doc_to_text(self, doc):
        return ("TITLE: " + doc["title"] + "\n"
                + "ABSTRACT: " + doc["abstract"] + "\n\n"
                + "Q: " + doc["question"] + "\n\nA:")

    def doc_to_target(self, doc):
        answer = doc["answer"]
        if isinstance(answer, list):
            answer = ", ".join(answer)
        return " " + answer

    def construct_requests(self, doc, ctx):
        if doc["answer_type"] == "free form answer":
            return [rf.greedy_until(ctx, ["\n"])[0]]
        if doc["answer_type"] == "bool":
            return [rf.loglikelihood(ctx, " yes")[0],
                    rf.loglikelihood(ctx, " no")[0]]
        return []

    @staticmethod
    def _token_f1(prediction, ground_truth):
        from .metrics import compute_f1

        return compute_f1(ground_truth, prediction)

    def process_results(self, doc, results):
        if doc["answer_type"] == "bool" and len(results) == 2:
            ll_yes, ll_no = results
            gold = 1 if doc["answer"] == "yes" else 0
            return {"f1_yesno": (gold, int(ll_yes > ll_no))}
        if doc["answer_type"] == "free form answer" and len(results) == 1:
            return {"f1_abstractive": self._token_f1(results[0],
                                                     doc["answer"])}
        return {}

    def aggregation(self):
        from .metrics import f1_score

        return {"f1_yesno": f1_score, "f1_abstractive": mean}

    def higher_is_better(self):
        return {"f1_yesno": True, "f1_abstractive": True}


QA_TASKS = {
    "qasper": QASPER,
    "anli_r1": ANLIRound1,
    "anli_r2": ANLIRound2,
    "anli_r3": ANLIRound3,
    "swag": SWAG,
    "webqs": WebQs,
    "logiqa": LogiQA,
    "mathqa": MathQA,
    "race": RACE,
    "wsc273": WinogradSchemaChallenge273,
    "headqa": HeadQAEs,  # deprecated alias kept for parity
    "headqa_en": HeadQAEn,
    "headqa_es": HeadQAEs,
    "pubmedqa": PubmedQA,
    "qa4mre_2011": QA4MRE_2011,
    "qa4mre_2012": QA4MRE_2012,
    "qa4mre_2013": QA4MRE_2013,
    "prost": PROST,
    "mc_taco": MCTACO,
    "mutual": MuTual,
    "mutual_plus": MuTualPlus,
}
