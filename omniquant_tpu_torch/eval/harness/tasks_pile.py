"""Pile perplexity tasks — 22 subsets (reference lm_eval/tasks/pile.py).

The reference loads these through a local dataset-builder script
(lm_eval/datasets/pile/pile.py) reading the public validation/test shards;
here the HF hub id is used and offline runs inject `data` directly."""
from __future__ import annotations

from .base import PerplexityTask


class PilePerplexityTask(PerplexityTask):
    VERSION = 1
    DATASET_PATH = "EleutherAI/the_pile"
    DATASET_NAME = None

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def _texts(self, split):
        rows = self.data[split]
        for doc in rows:
            yield doc["text"] if isinstance(doc, dict) else doc

    def validation_docs(self):
        return self._texts("validation")

    def test_docs(self):
        return self._texts("test")


# registry key suffix -> pile subset name (reference pile.py:51-133; the
# "pile_upsto" typo in the reference's USPTO DATASET_NAME is not reproduced)
PILE_SUBSETS = [
    "arxiv", "books3", "bookcorpus2", "dm-mathematics", "enron", "europarl",
    "freelaw", "github", "gutenberg", "hackernews", "nih-exporter",
    "opensubtitles", "openwebtext2", "philpapers", "pile-cc",
    "pubmed-abstracts", "pubmed-central", "stackexchange", "uspto",
    "ubuntu-irc", "wikipedia", "youtubesubtitles",
]


def _make_pile(subset):
    return type(
        "Pile_" + subset.replace("-", "_"), (PilePerplexityTask,),
        {"DATASET_NAME": f"pile_{subset}"})


PILE_TASKS = {f"pile_{subset}": _make_pile(subset) for subset in PILE_SUBSETS}
