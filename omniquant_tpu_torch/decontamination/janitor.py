"""13-gram train/test decontamination (reference lm_eval/decontamination/
janitor.py role), with a C-accelerated scanner and a pure-Python fallback.

The C extension (_janitor_ext.c, plain CPython C API) is compiled on first
use with the system compiler into the repository's git-ignored ``build/``
(named by a hash of the source, so an edited source is rebuilt), and loaded
from there by path; if that fails the Python path is used.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import string
import subprocess
import sysconfig
from pathlib import Path
from typing import List

_EXT = None
BUILD = Path(__file__).resolve().parent.parent.parent / "build"


def _ext_path() -> Path:
    """build/_janitor_ext-<source hash><EXT_SUFFIX>."""
    src = Path(__file__).resolve().parent / "_janitor_ext.c"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD / f"_janitor_ext-{digest}{suffix}"


def _try_build_ext():
    """Compile _janitor_ext.c into build/ once; returns module or None."""
    global _EXT
    if _EXT is not None:
        return _EXT
    import importlib.machinery
    import importlib.util

    src = Path(__file__).resolve().parent / "_janitor_ext.c"
    out = _ext_path()
    if not out.exists():
        include = sysconfig.get_paths()["include"]
        cc = os.environ.get("CC", "cc")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cc, "-O3", "-shared", "-fPIC", f"-I{include}", str(src),
               "-o", str(tmp)]
        try:
            BUILD.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)  # atomic: concurrent builders never race
        except Exception:
            return None
        finally:
            if tmp.exists():
                tmp.unlink()
    try:
        # loaded by path and kept out of sys.modules, so no other package's
        # _janitor_ext can stand in for it
        loader = importlib.machinery.ExtensionFileLoader("_janitor_ext",
                                                         str(out))
        spec = importlib.util.spec_from_file_location(
            "_janitor_ext", str(out), loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _EXT = mod
        return _EXT
    except Exception:
        return None


# ---------------------------------------------------------------------------
# pure-python fallback (reference janitor.py:22-43 nltk-style)
# ---------------------------------------------------------------------------

def form_ngrams(sequence, n):
    history = []
    while n > 1:
        try:
            next_item = next(sequence)
        except StopIteration:
            return
        history.append(next_item)
        n -= 1
    for item in sequence:
        history.append(item)
        yield tuple(history)
        del history[0]


def word_ngrams(s: str, n: int):
    tokens = s.split()
    return (" ".join(gram) for gram in form_ngrams(iter(tokens), n))


def _py_tokenize_with_indices(s: str, delete_chars: str):
    delset = set(delete_chars)
    words, cur, start, end = [], [], -1, -1
    for i, ch in enumerate(s + " "):
        if ch in delset and i < len(s):
            continue
        if not ch.isspace() and i < len(s):
            cur.append(ch.lower())
            if start < 0:
                start = i
            end = i
            continue
        if cur:
            words.append(("".join(cur), start, end))
            cur, start, end = [], -1, -1
    return words


def _py_clean_ngram(s, delete_chars, n, with_indices):
    words = _py_tokenize_with_indices(s, delete_chars)
    out = []
    for i in range(len(words) - n + 1):
        gram = " ".join(w for w, _, _ in words[i : i + n])
        if with_indices:
            out.append((gram, words[i][1], words[i + n - 1][2] + 1))
        else:
            out.append(gram)
    return out


class Janitor:
    """reference lm_eval/decontamination/janitor.py:106-260 semantics."""

    def __init__(self, ngram_n=13, window_to_remove=200, too_dirty_cutoff=10,
                 minimum_slice_length=200,
                 delete_chars=string.punctuation):
        self.ngram_n = ngram_n
        self.window_to_remove = window_to_remove
        self.too_dirty_cutoff = too_dirty_cutoff
        self.minimum_slice_length = minimum_slice_length
        self.delete_chars = delete_chars
        self.dirt_ngrams = set()
        self._ext = _try_build_ext()

    @property
    def using_cpp(self) -> bool:
        return self._ext is not None

    # I/O ------------------------------------------------------------------
    def save_contamination_ngrams(self, filename):
        with open(filename, "wb") as fp:
            pickle.dump(self.dirt_ngrams, fp)

    def load_contamination_ngrams(self, filename):
        with open(filename, "rb") as fp:
            self.dirt_ngrams = pickle.load(fp)

    # API ------------------------------------------------------------------
    def _ngrams(self, s, with_indices):
        if self._ext is not None:
            fn = (self._ext.clean_ngram_with_indices if with_indices
                  else self._ext.clean_ngram)
            return fn(s, self.delete_chars, self.ngram_n)
        return _py_clean_ngram(s, self.delete_chars, self.ngram_n,
                               with_indices)

    def register_contaminant(self, dirt_string: str):
        """Break a test document into n-grams to scrub from training data."""
        self.dirt_ngrams.update(self._ngrams(dirt_string, False))

    def clean(self, dirty_string: str) -> List[str]:
        """Remove contaminated spans; returns clean chunks (empty when the
        document is too dirty — reference :210-227)."""
        contamination_indices = (
            (gram, start, end)
            for gram, start, end in self._ngrams(dirty_string, True)
            if gram in self.dirt_ngrams
        )
        return self._split_chunks(dirty_string, contamination_indices)

    def contaminated(self, dirty_string: str) -> bool:
        """True if the document contains any registered contaminant n-gram."""
        return any(
            gram in self.dirt_ngrams
            for gram in self._ngrams(dirty_string, False)
        )

    def _split_chunks(self, dirty_string, dirty_parts):
        clean_chunks = []
        splice_idx = 0
        end = -1
        for i, (ngram, start, end) in enumerate(dirty_parts):
            if i >= self.too_dirty_cutoff:
                return []
            start = max(0, start - self.window_to_remove)
            end = min(len(dirty_string), end + self.window_to_remove)
            if start - splice_idx > self.minimum_slice_length:
                clean_chunks.append(dirty_string[splice_idx:start])
            splice_idx = end
        if end < len(dirty_string) - self.minimum_slice_length:
            clean_chunks.append(dirty_string[end + 1:])
        return clean_chunks
