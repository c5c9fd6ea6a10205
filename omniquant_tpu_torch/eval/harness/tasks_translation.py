"""WMT / IWSLT translation tasks (reference lm_eval/tasks/translation.py).

Task set matches the reference's selected benchmarks (wmt14 en<->fr,
wmt16 en<->{de,ro}, all wmt20 pairs, iwslt17 en<->ar). Source/reference
sentences come from sacrebleu's test sets (cached download) or injected
`data` ({"test": [{"src":..., "ref":...}]}) for offline runs. Scoring is
corpus BLEU/chrF/TER via the bleu/chrf/ter aggregations in metrics.py."""
from __future__ import annotations

from .base import Task, rf
from .metrics import bleu, chrf, ter

# code -> English language name (the reference uses pycountry, which is not
# in this image; wmt14/16/20 + iwslt17 cover exactly these codes)
LANG_NAMES = {
    "cs": "Czech", "de": "German", "en": "English", "es": "Spanish",
    "fr": "French", "iu": "Inuktitut", "ja": "Japanese", "km": "Khmer",
    "pl": "Polish", "ps": "Pashto", "ro": "Romanian", "ru": "Russian",
    "ta": "Tamil", "zh": "Chinese", "ar": "Arabic",
}

# reference lm_eval/tasks/__init__.py:60-72
GPT3_TRANSLATION_BENCHMARKS = {
    "wmt14": ["en-fr", "fr-en"],
    "wmt16": ["en-ro", "ro-en", "de-en", "en-de"],
}

WMT20_PAIRS = [
    "cs-en", "de-en", "de-fr", "en-cs", "en-de", "en-iu", "en-ja", "en-km",
    "en-pl", "en-ps", "en-ru", "en-ta", "en-zh", "fr-de", "iu-en", "ja-en",
    "km-en", "pl-en", "ps-en", "ru-en", "ta-en", "zh-en",
]

SELECTED_TRANSLATION_BENCHMARKS = {
    **GPT3_TRANSLATION_BENCHMARKS,
    "wmt20": WMT20_PAIRS,
    "iwslt17": ["en-ar", "ar-en"],
}


def code_to_language(code):
    return LANG_NAMES.get(code, code)


class GeneralTranslationTask(Task):
    """reference translation.py:100-212."""

    SACREBLEU_DATASET: str = ""
    LANGUAGE_PAIR: str = ""

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def download(self):
        from sacrebleu import sacrebleu

        src_file, ref_file = sacrebleu.download_test_set(
            self.SACREBLEU_DATASET, self.LANGUAGE_PAIR)
        src_data, ref_data = [
            [line.rstrip() for line in sacrebleu.smart_open(f)]
            for f in (src_file, ref_file)
        ]
        self._data = {"test": [
            {"src": src, "ref": ref} for src, ref in zip(src_data, ref_data)
        ]}

    def test_docs(self):
        return self.data["test"]

    def doc_to_text(self, doc):
        src_code, tgt_code = self.LANGUAGE_PAIR.split("-")
        return (f"{code_to_language(src_code)} phrase: " + doc["src"]
                + f"\n{code_to_language(tgt_code)} phrase:")

    def doc_to_target(self, doc):
        ref = doc["ref"]
        return " " + ref if isinstance(ref, str) else ref[0]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["\n"])[0]]

    def process_results(self, doc, results):
        # zh/ja targets would need jieba/nagisa word-splitting (reference
        # translation.py:64-84); neither is in this image, so refs/preds for
        # those pairs are scored unsegmented.
        ref_pred = (doc["ref"], results)
        return {"bleu": ref_pred, "chrf": ref_pred, "ter": ref_pred}

    def aggregation(self):
        return {"bleu": bleu, "chrf": chrf, "ter": ter}

    def higher_is_better(self):
        return {"bleu": True, "chrf": True, "ter": False}


def _make_translation_task(dataset, pair):
    return type(
        f"Translation_{dataset}_{pair.replace('-', '_')}",
        (GeneralTranslationTask,),
        {"SACREBLEU_DATASET": dataset, "LANGUAGE_PAIR": pair},
    )


TRANSLATION_TASKS = {
    f"{dataset}-{pair}": _make_translation_task(dataset, pair)
    for dataset, pairs in SELECTED_TRANSLATION_BENCHMARKS.items()
    for pair in pairs
}
