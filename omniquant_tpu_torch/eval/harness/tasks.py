"""Task definitions — the zero-shot suite the reference's configs use
(SURVEY.md §6: PIQA, ARC-e/c, BoolQ, HellaSwag, WinoGrande, plus lambada,
wikitext ppl, and the 57 hendrycksTest/MMLU subjects with category rollup).

Prompt formats follow the reference's task modules (lm_eval/tasks/*.py) so
accuracies are comparable. Tasks accept an injected `data` dict for offline
testing; otherwise they load from HF datasets.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

from .base import MultipleChoiceTask, PerplexityTask, Task, rf
from .metrics import mean


class PIQA(MultipleChoiceTask):
    """reference lm_eval/tasks/piqa.py"""

    DATASET_PATH = "piqa"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def has_training_docs(self):
        return True

    def training_docs(self):
        return map(self._convert, self.data["train"])

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    def _convert(self, doc):
        return {
            "goal": doc["goal"],
            "choices": [doc["sol1"], doc["sol2"]],
            "gold": doc["label"],
        }

    def doc_to_text(self, doc):
        return "Question: " + doc["goal"] + "\nAnswer:"


class ARCEasy(MultipleChoiceTask):
    """reference lm_eval/tasks/arc.py"""

    DATASET_PATH = "ai2_arc"
    DATASET_NAME = "ARC-Easy"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def has_training_docs(self):
        return True

    def training_docs(self):
        return map(self._convert, self.data["train"])

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    def test_docs(self):
        return map(self._convert, self.data["test"])

    def _convert(self, doc):
        num_to_letter = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}
        answer = num_to_letter.get(doc["answerKey"], doc["answerKey"])
        return {
            "query": "Question: " + doc["question"] + "\nAnswer:",
            "choices": doc["choices"]["text"],
            "gold": ["A", "B", "C", "D", "E"].index(answer),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class ARCChallenge(ARCEasy):
    DATASET_NAME = "ARC-Challenge"


class BoolQ(Task):
    """reference lm_eval/tasks/superglue.py BoolQ: yes/no loglikelihood."""

    DATASET_PATH = "super_glue"
    DATASET_NAME = "boolq"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def has_training_docs(self):
        return True

    def training_docs(self):
        return self.data["train"]

    def validation_docs(self):
        return self.data["validation"]

    def doc_to_text(self, doc):
        return (f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:")

    def doc_to_target(self, doc):
        return " " + ("yes" if doc["label"] else "no")

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " yes")[0],
                rf.loglikelihood(ctx, " no")[0]]

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        pred = ll_yes > ll_no
        return {"acc": float(pred == bool(doc["label"]))}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class HellaSwag(MultipleChoiceTask):
    """reference lm_eval/tasks/hellaswag.py incl. its detokenizer."""

    DATASET_PATH = "hellaswag"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def has_training_docs(self):
        return True

    def training_docs(self):
        return map(self._convert, self.data["train"])

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    @classmethod
    def preprocess(cls, text):
        text = text.strip()
        text = text.replace(" [title]", ". ")
        text = re.sub("\\[.*?\\]", "", text)
        text = text.replace("  ", " ")
        return text

    def _convert(self, doc):
        ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
        return {
            "query": self.preprocess(doc["activity_label"] + ": " + ctx),
            "choices": [self.preprocess(e) for e in doc["endings"]],
            "gold": int(doc["label"]),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class WinoGrande(Task):
    """reference lm_eval/tasks/winogrande.py: partial-evaluation scoring —
    fill the blank with each option, score the shared continuation."""

    DATASET_PATH = "winogrande"
    DATASET_NAME = "winogrande_xl"
    answer_to_num = {"1": 0, "2": 1}

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def has_training_docs(self):
        return True

    def training_docs(self):
        return self.data["train"]

    def validation_docs(self):
        return self.data["validation"]

    def doc_to_text(self, doc):
        return self.partial_context(doc, doc["option" + doc["answer"]])

    @classmethod
    def partial_context(cls, doc, option):
        pronoun_loc = doc["sentence"].index("_")
        return doc["sentence"][:pronoun_loc] + option

    @classmethod
    def partial_target(cls, doc):
        pronoun_loc = doc["sentence"].index("_") + 1
        return " " + doc["sentence"][pronoun_loc:].strip()

    def doc_to_target(self, doc):
        return self.partial_target(doc)

    def construct_requests(self, doc, ctx):
        target = self.partial_target(doc)
        reqs = []
        for option in [doc["option1"], doc["option2"]]:
            partial_ctx = self.partial_context(doc, option)
            full_ctx = self.append_context(ctx, partial_ctx)
            reqs.append(rf.loglikelihood(full_ctx, target)[0])
        return reqs

    @classmethod
    def append_context(cls, ctx, partial_ctx):
        ctx = ctx.split("\n\n")
        ctx[-1] = partial_ctx
        return "\n\n".join(ctx)

    def process_results(self, doc, results):
        return {"acc": float(
            np.argmax(results) == self.answer_to_num[doc["answer"]])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class LambadaOpenAI(Task):
    """reference lm_eval/tasks/lambada.py: final-word prediction; reports
    ppl over the target word and greedy accuracy."""

    DATASET_PATH = "EleutherAI/lambada_openai"
    DATASET_NAME = "en"

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return self.data["test"]

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0]

    def doc_to_target(self, doc):
        return " " + doc["text"].rsplit(" ", 1)[1]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, self.doc_to_target(doc))]

    def process_results(self, doc, results):
        ll, is_greedy = results[0]
        return {"ppl": ll, "acc": float(is_greedy)}

    def aggregation(self):
        from .metrics import perplexity

        return {"ppl": perplexity, "acc": mean}

    def higher_is_better(self):
        return {"ppl": False, "acc": True}


def wikitext_detokenizer(string):
    """reference lm_eval/tasks/wikitext.py:28-59."""
    string = string.replace("s '", "s'")
    string = re.sub(r"/' [0-9]/", r"/'[0-9]/", string)
    string = string.replace(" @-@ ", "-")
    string = string.replace(" @,@ ", ",")
    string = string.replace(" @.@ ", ".")
    string = string.replace(" : ", ": ")
    string = string.replace(" ; ", "; ")
    string = string.replace(" . ", ". ")
    string = string.replace(" ! ", "! ")
    string = string.replace(" ? ", "? ")
    string = string.replace(" , ", ", ")
    string = re.sub(r"\(\s*([^\)]*?)\s*\)", r"(\1)", string)
    string = re.sub(r"\[\s*([^\]]*?)\s*\]", r"[\1]", string)
    string = re.sub(r"{\s*([^}]*?)\s*}", r"{\1}", string)
    string = re.sub(r"\"\s*([^\"]*?)\s*\"", r'"\1"', string)
    string = re.sub(r"'\s*([^']*?)\s*'", r"'\1'", string)
    string = string.replace("= = = =", "====")
    string = string.replace("= = =", "===")
    string = string.replace("= =", "==")
    string = string.replace(" " + chr(176) + " ", chr(176))
    string = string.replace(" \n", "\n")
    string = string.replace("\n ", "\n")
    string = string.replace(" N ", " 1 ")
    string = string.replace(" 's", "'s")
    return string


class WikiText(PerplexityTask):
    """reference lm_eval/tasks/wikitext.py:62-96."""

    DATASET_PATH = "wikitext"
    DATASET_NAME = "wikitext-2-raw-v1"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def _docs(self, split):
        rows = self.data[split]["text"] if not isinstance(
            self.data[split], list) else self.data[split]
        # rejoin per-line rows into documents split on section headings
        doc, out = [], []
        for line in rows:
            rline = line.replace("= = =", "===").replace("= =", "==").strip()
            if rline.startswith("= ") and rline.strip().endswith(" ="):
                if doc:
                    out.append("".join(doc))
                doc = []
            doc.append(line)
        if doc:
            out.append("".join(doc))
        return [wikitext_detokenizer(d) for d in out]

    def validation_docs(self):
        return self._docs("validation")

    def test_docs(self):
        return self._docs("test")

    def count_words(self, doc):
        return len(re.split(r"\s+", doc))


class HendrycksTest(MultipleChoiceTask):
    """One MMLU subject (reference lm_eval/tasks/hendrycks_test.py)."""

    DATASET_PATH = "cais/mmlu"

    def __init__(self, subject: str, data=None):
        self.DATASET_NAME = subject
        self.subject = subject
        super().__init__(data)

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    def test_docs(self):
        return map(self._convert, self.data["test"])

    def fewshot_description(self):
        subject = self.subject.replace("_", " ")
        return (f"The following are multiple choice questions (with answers) "
                f"about {subject}.")

    def _convert(self, doc):
        keys = ["A", "B", "C", "D"]
        question = doc["question"].strip()
        choices = "".join(
            f"{k}. {c}\n" for k, c in zip(keys, doc["choices"]))
        return {
            "query": f"{question}\n{choices}Answer:",
            "choices": keys,
            "gold": doc["answer"] if isinstance(doc["answer"], int)
            else keys.index(doc["answer"]),
            "raw_choices": doc["choices"],
        }

    def doc_to_text(self, doc):
        return doc["query"]


MMLU_SUBJECTS = [
    "abstract_algebra", "anatomy", "astronomy", "business_ethics",
    "clinical_knowledge", "college_biology", "college_chemistry",
    "college_computer_science", "college_mathematics", "college_medicine",
    "college_physics", "computer_security", "conceptual_physics",
    "econometrics", "electrical_engineering", "elementary_mathematics",
    "formal_logic", "global_facts", "high_school_biology",
    "high_school_chemistry", "high_school_computer_science",
    "high_school_european_history", "high_school_geography",
    "high_school_government_and_politics", "high_school_macroeconomics",
    "high_school_mathematics", "high_school_microeconomics",
    "high_school_physics", "high_school_psychology",
    "high_school_statistics", "high_school_us_history",
    "high_school_world_history", "human_aging", "human_sexuality",
    "international_law", "jurisprudence", "logical_fallacies",
    "machine_learning", "management", "marketing", "medical_genetics",
    "miscellaneous", "moral_disputes", "moral_scenarios", "nutrition",
    "philosophy", "prehistory", "professional_accounting",
    "professional_law", "professional_medicine", "professional_psychology",
    "public_relations", "security_studies", "sociology",
    "us_foreign_policy", "virology", "world_religions",
]


def build_task_registry():
    reg = {
        "piqa": PIQA,
        "arc_easy": ARCEasy,
        "arc_challenge": ARCChallenge,
        "boolq": BoolQ,
        "hellaswag": HellaSwag,
        "winogrande": WinoGrande,
        "lambada_openai": LambadaOpenAI,
        "lambada": LambadaOpenAI,
        "wikitext": WikiText,
    }
    for s in MMLU_SUBJECTS:
        reg[f"hendrycksTest-{s}"] = (
            lambda data=None, s=s: HendrycksTest(s, data))
    return reg


TASK_REGISTRY = build_task_registry()


# ---------------------------------------------------------------------------
# additional common zero-shot tasks
# ---------------------------------------------------------------------------

class OpenBookQA(MultipleChoiceTask):
    DATASET_PATH = "openbookqa"
    DATASET_NAME = "main"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    def test_docs(self):
        return map(self._convert, self.data["test"])

    def _convert(self, doc):
        return {
            "query": doc["question_stem"],
            "choices": doc["choices"]["text"],
            "gold": ["A", "B", "C", "D"].index(doc["answerKey"].strip()),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class SciQ(MultipleChoiceTask):
    DATASET_PATH = "sciq"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return map(self._convert, self.data["validation"])

    def test_docs(self):
        return map(self._convert, self.data["test"])

    def _convert(self, doc):
        choices = [doc["distractor1"], doc["distractor2"],
                   doc["distractor3"], doc["correct_answer"]]
        src = doc.get("support", "")
        return {
            "source": src,
            "query": doc["question"],
            "choices": choices,
            "gold": 3,
        }

    def doc_to_text(self, doc):
        return f"{doc['source']}\nQuestion: {doc['query']}\nAnswer:".strip()


class COPA(Task):
    """reference lm_eval/tasks/superglue.py Copa: cause/effect continuation."""

    DATASET_PATH = "super_glue"
    DATASET_NAME = "copa"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.data["validation"]

    def doc_to_text(self, doc):
        connector = {"cause": "because", "effect": "therefore"}[
            doc["question"]]
        return doc["premise"].strip()[:-1] + f" {connector}"

    def doc_to_target(self, doc):
        correct = doc["choice1"] if doc["label"] == 0 else doc["choice2"]
        return " " + correct[0].lower() + correct[1:]

    def construct_requests(self, doc, ctx):
        def conv(choice):
            return " " + choice[0].lower() + choice[1:]
        return [rf.loglikelihood(ctx, conv(doc["choice1"]))[0],
                rf.loglikelihood(ctx, conv(doc["choice2"]))[0]]

    def process_results(self, doc, results):
        return {"acc": float(np.argmax(results) == doc["label"])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class RTE(Task):
    """GLUE RTE (reference lm_eval/tasks/glue.py)."""

    DATASET_PATH = "glue"
    DATASET_NAME = "rte"

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.data["validation"]

    def doc_to_text(self, doc):
        return (f"{doc['sentence1']}\nQuestion: {doc['sentence2']} "
                "True or False?\nAnswer:")

    def doc_to_target(self, doc):
        return " " + ["True", "False"][doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " True")[0],
                rf.loglikelihood(ctx, " False")[0]]

    def process_results(self, doc, results):
        return {"acc": float(np.argmax(results) == doc["label"])}

    def aggregation(self):
        return {"acc": mean}

    def higher_is_better(self):
        return {"acc": True}


class SST(RTE):
    """GLUE SST-2 sentiment."""

    DATASET_PATH = "glue"
    DATASET_NAME = "sst2"

    def doc_to_text(self, doc):
        s = doc["sentence"].strip()
        return f"{s}\nQuestion: Is this sentence positive or negative?\nAnswer:"

    def doc_to_target(self, doc):
        return " " + ["negative", "positive"][doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " negative")[0],
                rf.loglikelihood(ctx, " positive")[0]]


TASK_REGISTRY.update({
    "openbookqa": OpenBookQA,
    "sciq": SciQ,
    "copa": COPA,
    "rte": RTE,
    "sst": SST,
})


# ---------------------------------------------------------------------------
# extended suites (reference lm_eval/tasks/__init__.py:86-313): GLUE /
# SuperGLUE, 67 BLiMP pairs, 22 Pile subsets, bias (crows_pairs, toxigen)
# ---------------------------------------------------------------------------

from .tasks_bias import BIAS_TASKS  # noqa: E402
from .tasks_blimp import BLIMP_TASKS  # noqa: E402
from .tasks_gen import GEN_TASKS  # noqa: E402
from .tasks_glue import GLUE_TASKS  # noqa: E402
from .tasks_math import MATH_TASKS  # noqa: E402
from .tasks_pile import PILE_TASKS  # noqa: E402
from .tasks_qa import QA_TASKS  # noqa: E402
from .tasks_translation import TRANSLATION_TASKS  # noqa: E402

TASK_REGISTRY.update(GLUE_TASKS)
TASK_REGISTRY.update(BLIMP_TASKS)
TASK_REGISTRY.update(PILE_TASKS)
TASK_REGISTRY.update(BIAS_TASKS)
TASK_REGISTRY.update(QA_TASKS)
TASK_REGISTRY.update(MATH_TASKS)
TASK_REGISTRY.update(GEN_TASKS)
TASK_REGISTRY.update(TRANSLATION_TASKS)


# ---------------------------------------------------------------------------
# decontamination hooks: which text each task exposes to the 13-gram
# train/test overlap scan (matches the reference's per-task
# doc_to_decontamination_query definitions)
# ---------------------------------------------------------------------------

PIQA.enable_decontamination(lambda d: d["goal"])
ARCEasy.enable_decontamination(lambda d: d["query"])
ARCChallenge.enable_decontamination(lambda d: d["query"])
BoolQ.enable_decontamination(lambda d: d["passage"])
HellaSwag.enable_decontamination(lambda d: d["query"])
WinoGrande.enable_decontamination(lambda d: d["sentence"])
LambadaOpenAI.enable_decontamination(lambda d: d["text"])
HendrycksTest.enable_decontamination(lambda d: d["query"])
OpenBookQA.enable_decontamination(lambda d: d["query"])
SciQ.enable_decontamination(lambda d: d["source"] + " " + d["query"])

from .tasks_blimp import BlimpTask as _BlimpTask  # noqa: E402
from .tasks_gen import (  # noqa: E402
    CoQA as _CoQA, DROP as _DROP, LambadaStandard as _LambadaStandard,
    SQuAD2 as _SQuAD2, TriviaQA as _TriviaQA,
    TruthfulQAGeneration as _TQAGen, TruthfulQAMultipleChoice as _TQAMC)
from .tasks_math import (  # noqa: E402
    Arithmetic as _Arithmetic, Asdiv as _Asdiv, EthicsCM as _EthicsCM,
    EthicsDeontology as _EthicsDeontology, EthicsJustice as _EthicsJustice,
    EthicsVirtue as _EthicsVirtue, Math as _Math,
    WordUnscrambleTask as _Unscramble)
from .tasks_qa import (  # noqa: E402
    ANLIBase as _ANLIBase, HeadQABase as _HeadQABase, LogiQA as _LogiQA,
    MCTACO as _MCTACO, MathQA as _MathQA, MuTualBase as _MuTualBase,
    PROST as _PROST, PubmedQA as _PubmedQA, QA4MRE as _QA4MRE, RACE as _RACE,
    WebQs as _WebQs, WinogradSchemaChallenge273 as _WSC273)
from .tasks_translation import GeneralTranslationTask as _Translation  # noqa: E402

_BlimpTask.enable_decontamination(
    lambda d: d["sentence_good"] + " " + d["sentence_bad"])
_ANLIBase.enable_decontamination(lambda d: d["premise"])
_WebQs.enable_decontamination(lambda d: d["question"])
_LogiQA.enable_decontamination(lambda d: d["query"])
_MathQA.enable_decontamination(lambda d: d["query"])
_RACE.enable_decontamination(lambda d: d["article"])
_WSC273.enable_decontamination(lambda d: d["text"])
_HeadQABase.enable_decontamination(lambda d: d["query"])
_PubmedQA.enable_decontamination(
    lambda d: d["question"] + " " + "\n".join(d["context"]["contexts"]))
_QA4MRE.enable_decontamination(lambda d: d["source"] + " " + d["query"])
_PROST.enable_decontamination(lambda d: d["query"])
_MCTACO.enable_decontamination(lambda d: d["question"] + " " + d["sentence"])
_MuTualBase.enable_decontamination(lambda d: d["article"])
_Math.enable_decontamination(lambda d: d["problem"])
_Asdiv.enable_decontamination(lambda d: d["body"] + " " + d["question"])
_Arithmetic.enable_decontamination(lambda d: d["context"])
_Unscramble.enable_decontamination(lambda d: d["context"])
_EthicsCM.enable_decontamination(lambda d: d["input"])
_EthicsDeontology.enable_decontamination(
    lambda d: " ".join([d["scenario"], d["excuse"]]))
_EthicsJustice.enable_decontamination(lambda d: d["scenario"])
_EthicsVirtue.enable_decontamination(lambda d: d["scenario"])
_TQAMC.enable_decontamination(lambda d: d["question"])
_TQAGen.enable_decontamination(lambda d: d["question"])
_LambadaStandard.enable_decontamination(lambda d: d["text"])
_SQuAD2.enable_decontamination(lambda d: d["context"])
_CoQA.enable_decontamination(
    lambda d: d["story"] + " " + "\n".join(d["questions"]["input_text"]))
_DROP.enable_decontamination(lambda d: d["passage"] + " " + d["question"])
_TriviaQA.enable_decontamination(lambda d: d["question"])
_Translation.enable_decontamination(lambda d: d["src"])
