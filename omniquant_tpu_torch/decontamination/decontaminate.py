"""Train/test overlap detection for eval docs
(reference lm_eval/decontamination/decontaminate.py role).

Instead of the reference's zstd-archived Pile ngram files, this takes any
iterable of training documents (or a directory of text files) and flags eval
docs whose 13-grams appear in training data.
"""
from __future__ import annotations

import glob
import os
import random
from typing import Dict, Iterable, List

from .janitor import Janitor


def get_train_overlap_stub(docs: List, ngrams_path: str, ngrams_n_size: int):
    """Simulated 10% overlap (reference decontaminate.py:13-17) — for
    testing the evaluator decoupled from the full scan."""
    simulated_overlap = 0.1
    contaminated = int(len(docs) * simulated_overlap)
    return random.sample(range(len(docs)), contaminated)


def get_train_overlap(
    docs_by_task: Dict[str, List[str]],
    train_docs: Iterable[str] = None,
    train_path: str = None,
    ngrams_n_size: int = 13,
    limit: int = None,
) -> Dict[str, set]:
    """Returns {task_name: set(doc_indices overlapping training data)}.

    Registers each eval doc's n-grams, then scans the training corpus once —
    the reverse orientation of the reference (which builds training n-gram
    archives offline) but the same 13-gram criterion.
    """
    janitor = Janitor(ngram_n=ngrams_n_size)
    # register eval docs, remembering which (task, idx) each ngram came from
    ngram_owners: Dict[str, set] = {}
    for task, docs in docs_by_task.items():
        for i, doc in enumerate(docs):
            if limit is not None and i >= limit:
                break
            for gram in janitor._ngrams(doc, False):
                ngram_owners.setdefault(gram, set()).add((task, i))

    if train_docs is None and train_path:
        def _iter():
            for fn in sorted(glob.glob(os.path.join(train_path, "*"))):
                with open(fn, "r", errors="ignore") as f:
                    yield f.read()
        train_docs = _iter()

    overlaps: Dict[str, set] = {task: set() for task in docs_by_task}
    if train_docs is None:
        return overlaps
    for tdoc in train_docs:
        for gram in janitor._ngrams(tdoc, False):
            if gram in ngram_owners:
                for task, i in ngram_owners[gram]:
                    overlaps[task].add(i)
    return overlaps
