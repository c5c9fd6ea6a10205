"""The port's harness modules that hold no model code -- tasks, metrics,
evaluator, categories, CachingLM, decontamination, the local dataset
loaders and the remote adapters -- against the JAX package's copies.

A deterministic stub LM (each score and each generation a function of a
hash of its request) drives both evaluators: the task registry has the
same keys, at least one task of every task module gives the same results
dict (serialised with every float's exact repr), the metrics agree on
seeded inputs, a sqlite cache written by JAX's CachingLM serves the port's
with no LM call, the train-overlap scan agrees (and the port's C scanner,
built into build/, agrees with its pure-Python one), each loader parses
the same files to equal dicts, and the remote adapters give equal results
and send equal payloads through an injected transport.
"""
import hashlib
import json
import string

import numpy as np
import pytest

import omniquant_tpu.decontamination as j_decon
import omniquant_tpu.eval.harness as jh
import omniquant_tpu_torch.decontamination as t_decon
import omniquant_tpu_torch.eval.harness as th
from omniquant_tpu.eval.harness import datasets_local as j_dl
from omniquant_tpu.eval.harness import metrics as j_metrics
from omniquant_tpu.eval.harness import remote as j_remote
from omniquant_tpu_torch.decontamination import janitor as t_janitor
from omniquant_tpu_torch.eval.harness import datasets_local as t_dl
from omniquant_tpu_torch.eval.harness import metrics as t_metrics
from omniquant_tpu_torch.eval.harness import remote as t_remote

import test_datasets_local
import test_remote_lm
from test_torch_harness import WORDS, task_docs


def _h(*args) -> int:
    return int(hashlib.sha256(repr(args).encode()).hexdigest()[:12], 16)


class StubLM:
    """Scores and generations from a hash of each request."""

    GENERATIONS = (" 42", " yes", " alice", "#### 7", " the cat", " 12 dogs")

    def __init__(self):
        self.calls = 0

    def loglikelihood(self, requests):
        self.calls += len(requests)
        return [(-(_h("ll", *r) % 10_000) / 997.0, bool(_h("g", *r) & 1))
                for r in requests]

    def loglikelihood_rolling(self, requests):
        self.calls += len(requests)
        return [-(_h("roll", *r) % 100_000) / 97.0 for r in requests]

    def greedy_until(self, requests):
        self.calls += len(requests)
        return [self.GENERATIONS[_h("gen", c, tuple(u)) % 6]
                for c, u in requests]


def _words(rng, n):
    return " ".join(rng.choice(WORDS, n))


def module_docs(seed=0):
    """Injected docs for one or more tasks of every task module (the schemas
    of tests/test_harness.py)."""
    rng = np.random.default_rng(seed)
    base = task_docs(seed)
    mmlu = {"validation": [], "test": [
        {"question": _words(rng, 4) + "?",
         "choices": [_words(rng, 1) for _ in range(4)],
         "answer": int(rng.integers(4))} for _ in range(5)]}
    glue = [{"sentence": _words(rng, 5) + ".", "label": int(rng.integers(2))}
            for _ in range(8)]
    multirc = [{"paragraph": f"p {i // 3}", "question": "q?",
                "answer": _words(rng, 2), "label": int(rng.integers(2)),
                "idx": {"paragraph": i // 3, "question": 0}}
               for i in range(6)]
    return {
        # tasks.py
        "piqa": base["piqa"],
        "boolq": {"train": [], "validation": [
            {"passage": _words(rng, 6), "question": _words(rng, 3),
             "label": int(rng.integers(2))} for _ in range(5)]},
        "winogrande": {"train": [], "validation": [
            {"sentence": f"The {_words(rng, 2)} because _ was heavy.",
             "option1": _words(rng, 1), "option2": _words(rng, 1),
             "answer": str(int(rng.integers(1, 3)))} for _ in range(4)]},
        "hendrycksTest-abstract_algebra": mmlu,
        "hendrycksTest-anatomy": mmlu,
        # tasks_bias
        "crows_pairs_english_age": {"test": [
            {"sent_more": _words(rng, 4), "sent_less": _words(rng, 4),
             "bias_type": "age"} for _ in range(5)]},
        # tasks_blimp
        "blimp_adjunct_island": {"train": [
            {"sentence_good": _words(rng, 4), "sentence_bad": _words(rng, 4)}
            for _ in range(5)]},
        # tasks_gen
        "lambada_standard": {"validation": [], "test": [
            {"text": _words(rng, 7)} for _ in range(5)]},
        # tasks_glue
        "cola": {"train": glue, "validation": glue},
        "multirc": {"train": multirc, "validation": multirc},
        "record": {"train": [], "validation": [{
            "passage": "intro text\n@highlight\nfact one",
            "query": "@placeholder was here", "entities": ["alice", "bob"],
            "answers": ["alice"]}]},
        # tasks_math
        "gsm8k": base["gsm8k"],
        # tasks_pile
        "pile_arxiv": {"validation": [_words(rng, 9) for _ in range(3)],
                       "test": [_words(rng, 9) for _ in range(3)]},
        # tasks_qa
        "truthfulqa_mc": {"validation": [
            {"question": _words(rng, 3) + "?",
             "mc1_targets": {"choices": [_words(rng, 2), _words(rng, 2)],
                             "labels": [1, 0]},
             "mc2_targets": {"choices": [_words(rng, 1) for _ in range(3)],
                             "labels": [1, 1, 0]}} for _ in range(3)]},
        # tasks_translation
        "wmt14-en-fr": {"test": [{"src": _words(rng, 4), "ref": _words(rng, 4)}
                                 for _ in range(3)]},
        # tasks.py, rolling
        "wikitext": base["wikitext"],
    }


MODULE_TASKS = {
    "tasks": ["piqa", "boolq", "winogrande", "hendrycksTest-abstract_algebra",
              "hendrycksTest-anatomy", "wikitext"],
    "tasks_bias": ["crows_pairs_english_age"],
    "tasks_blimp": ["blimp_adjunct_island"],
    "tasks_gen": ["lambada_standard"],
    "tasks_glue": ["cola", "multirc", "record"],
    "tasks_math": ["gsm8k"],
    "tasks_pile": ["pile_arxiv"],
    "tasks_qa": ["truthfulqa_mc"],
    "tasks_translation": ["wmt14-en-fr"],
}
# (module, tasks, num_fewshot): every module at 0 shots, and with one
# few-shot example the tasks that take one on these docs
CASES = [(m, t, 0) for m, t in MODULE_TASKS.items()] + [
    ("tasks", ["piqa"], 1), ("tasks_gen", ["lambada_standard"], 1),
    ("tasks_glue", ["cola", "multirc"], 1), ("tasks_math", ["gsm8k"], 1),
    ("tasks_translation", ["wmt14-en-fr"], 1)]


def _exact(x) -> str:
    """A results dict with every float as its exact repr (NaN included)."""
    return json.dumps(x, sort_keys=True, default=repr)


def test_task_registry_has_jax_keys():
    assert sorted(th.TASK_REGISTRY) == sorted(jh.TASK_REGISTRY)
    assert th.pattern_match(["hendrycksTest-*"], th.TASK_REGISTRY) == \
        jh.pattern_match(["hendrycksTest-*"], jh.TASK_REGISTRY)
    for name, cls in th.TASK_REGISTRY.items():
        assert cls.__name__ == jh.TASK_REGISTRY[name].__name__, name
        assert getattr(cls, "VERSION", None) == getattr(
            jh.TASK_REGISTRY[name], "VERSION", None), name


@pytest.mark.parametrize("module,tasks,num_fewshot", CASES,
                         ids=[f"{m}-{k}shot" for m, _, k in CASES])
def test_task_module_results_bit_equal(module, tasks, num_fewshot):
    """simple_evaluate through both packages with the stub LM: the same
    results dict, float for float (bootstrap stderrs included), and the
    same markdown table; MMLU's rollup likewise."""
    docs = module_docs()
    want = jh.simple_evaluate(StubLM(), tasks, num_fewshot=num_fewshot,
                              task_data=docs, bootstrap_iters=50)
    got = th.simple_evaluate(StubLM(), tasks, num_fewshot=num_fewshot,
                             task_data=docs, bootstrap_iters=50)
    assert _exact(got) == _exact(want)
    assert th.make_table(got) == jh.make_table(want)
    assert _exact(th.mmlu_rollup(got["results"])) == _exact(
        jh.mmlu_rollup(want["results"]))


def _metric_cases(rng):
    pairs = [(int(a), int(b)) for a, b in rng.integers(0, 2, (20, 2))]
    lls = [(float(-x), int(n)) for x, n in zip(rng.random(12) * 30,
                                               rng.integers(1, 40, 12))]
    items = [(bool(rng.integers(2)),
              {"label": int(rng.integers(2)),
               "idx": {"paragraph": int(p), "question": int(q)}})
             for p, q in rng.integers(0, 3, (15, 2))]
    sent = [(_words(rng, 5), _words(rng, 5)) for _ in range(6)]
    return [
        ("mean", (list(rng.random(17)),)),
        ("median", (list(rng.random(17)),)),
        ("perplexity", (list(-rng.random(9) * 5),)),
        ("weighted_mean", (lls,)),
        ("weighted_perplexity", (lls,)),
        ("bits_per_byte", (lls,)),
        ("matthews_corrcoef", (pairs,)),
        ("f1_score", (pairs,)),
        ("yesno", (1,)),
        ("acc_all", (items,)),
        ("normalize_answer", ("The  Cat, a dog!",)),
        ("compute_exact", ("The Cat!", "the cat")),
        ("compute_f1", (sent[0][0], sent[0][1])),
        ("bleu", (sent,)),
        ("chrf", (sent,)),
        ("ter", (sent,)),
    ]


def test_metrics_agree_on_seeded_inputs():
    rng = np.random.default_rng(3)
    for name, args in _metric_cases(rng):
        got = getattr(t_metrics, name)(*args)
        want = getattr(j_metrics, name)(*args)
        assert _exact(got) == _exact(want), name
    xs = list(rng.random(23))
    assert t_metrics.bootstrap_stderr(t_metrics.median, xs, 100) == \
        j_metrics.bootstrap_stderr(j_metrics.median, xs, 100)
    got = t_metrics.metric_max_over_ground_truths(
        t_metrics.compute_f1, "alpha bravo", ["bravo", "alpha x"])
    assert got == j_metrics.metric_max_over_ground_truths(
        j_metrics.compute_f1, "alpha bravo", ["bravo", "alpha x"])
    for agg in (t_metrics.mean, t_metrics.median, t_metrics.perplexity):
        se = t_metrics.stderr_for_metric(agg, 50)
        je = j_metrics.stderr_for_metric(getattr(j_metrics, agg.__name__), 50)
        assert (se is None) == (je is None)
        if se is not None:
            assert se(xs) == je(xs)


class RaisingLM:
    def __getattr__(self, name):
        raise AssertionError(f"the cache should have served {name}")


def test_jax_written_cache_serves_the_port(tmp_path):
    """A db written by JAX's CachingLM (one evaluation of three request
    types) serves the port's CachingLM, with the same fingerprint, without
    one LM call; another fingerprint misses."""
    db = str(tmp_path / "eval.db")
    docs = module_docs()
    tasks = ["piqa", "gsm8k", "wikitext", "lambada_standard"]
    stub = StubLM()
    want = jh.simple_evaluate(jh.CachingLM(stub, db, fingerprint="w4"),
                              tasks, task_data=docs, bootstrap_iters=50)
    assert stub.calls > 0
    got = th.simple_evaluate(th.CachingLM(RaisingLM(), db, fingerprint="w4"),
                             tasks, task_data=docs, bootstrap_iters=50)
    assert _exact(got) == _exact(want)
    other = StubLM()
    th.simple_evaluate(th.CachingLM(other, db, fingerprint="w3"), tasks,
                       task_data=docs, bootstrap_iters=50)
    assert other.calls == stub.calls


def test_dummy_lm_shapes():
    lm = th.DummyLM()
    assert lm.greedy_until([("x", ["\n"])]) == jh.DummyLM().greedy_until(
        [("x", ["\n"])])
    assert all(-1 <= x <= 0 for x, _ in lm.loglikelihood([("a", "b")] * 3))


def test_train_overlap_and_scanners_agree():
    """get_train_overlap equals JAX's; the port's C scanner (built into
    build/, loaded from there and never JAX's) equals its Python one."""
    rng = np.random.default_rng(5)
    docs = {"a": [_words(rng, 20) for _ in range(4)],
            "b": [_words(rng, 15) for _ in range(3)]}
    train = [_words(rng, 30), "x " + docs["a"][2] + " y",
             docs["b"][0][:60] + " tail"]
    for n in (5, 13):
        got = t_decon.get_train_overlap(docs, train_docs=train,
                                        ngrams_n_size=n, limit=3)
        want = j_decon.get_train_overlap(docs, train_docs=train,
                                         ngrams_n_size=n, limit=3)
        assert got == want and got["a"] == {2}
    ext = t_janitor._try_build_ext()
    assert ext is not None, "the C scanner did not build"
    assert t_janitor._ext_path().parent == t_janitor.BUILD
    assert ext.__file__ == str(t_janitor._ext_path())
    assert "omniquant_tpu_torch" not in ext.__file__
    text = "Hello, World! This is a TEST-case; gone. " + " ".join(WORDS)
    for n in (2, 5, 13):
        for idx in (False, True):
            fn = ext.clean_ngram_with_indices if idx else ext.clean_ngram
            assert fn(text, string.punctuation, n) == \
                t_janitor._py_clean_ngram(text, string.punctuation, n, idx)
    jan = t_decon.Janitor(ngram_n=3, minimum_slice_length=10,
                          window_to_remove=2)
    jj = j_decon.Janitor(ngram_n=3, minimum_slice_length=10,
                         window_to_remove=2)
    for j in (jan, jj):
        j.register_contaminant("secret leaked phrase")
    doc = ("a long stretch of fine text here . the secret leaked phrase "
           "appears . and afterwards more fine text continues on")
    assert jan.clean(doc) == jj.clean(doc) and jan.clean(doc)
    assert jan.contaminated(doc) and jan.dirt_ngrams == jj.dirt_ngrams


DATASET_TESTS = sorted(n for n in dir(test_datasets_local)
                       if n.startswith("test_"))


@pytest.mark.parametrize("name", DATASET_TESTS)
def test_local_loaders_parse_equal_dicts(name, tmp_path, monkeypatch):
    """Each case of tests/test_datasets_local.py, its files written as
    there, with every JAX loader it calls also run from the port on the
    same files: the dicts are equal."""
    calls = []

    def both(fname):
        def call(*a, **kw):
            want = getattr(j_dl, fname)(*a, **kw)
            got = getattr(t_dl, fname)(*a, **kw)
            assert got == want, fname
            calls.append(fname)
            return want
        return call

    proxy = type("Loaders", (), {
        f: staticmethod(both(f)) if f.startswith("load_") else getattr(j_dl, f)
        for f in dir(j_dl) if not f.startswith("__")})
    monkeypatch.setattr(test_datasets_local, "dl", proxy)
    getattr(test_datasets_local, name)(tmp_path)
    assert calls, f"{name} called no loader"


def test_remote_adapters_match_jax():
    """OpenAICompletionLM and TextSynthStyleLM of both packages over the
    same fake transports: equal results and equal payloads."""
    def openai(mod):
        api = test_remote_lm.FakeCompletionsAPI()
        lm = mod.OpenAICompletionLM(
            transport=api, tok_encode=test_remote_lm.tok_encode,
            tok_decode=test_remote_lm.tok_decode, eot_token_id=0,
            max_length=24, max_gen_toks=8, sleeper=lambda s: None)
        res = (lm.loglikelihood([("ab", "cd"), ("a", "bx"), ("q" * 40, "r")]),
               lm.loglikelihood_rolling([("hello world " * 5,)]),
               lm.greedy_until([("p1", ["."]), ("p2", [" and"]),
                                ("p3", ["."])]))
        return res, api.calls

    assert openai(t_remote) == openai(j_remote)

    def textsynth(mod):
        calls = []

        def transport(path, payload):
            calls.append((path, payload))
            if path == "logprob":
                return {"logprob": -len(payload["continuation"]) / 3,
                        "is_greedy": len(payload["context"]) % 2 == 0}
            return {"text": payload["prompt"][::-1]}

        lm = mod.TextSynthStyleLM(transport, sleeper=lambda s: None)
        return (lm.loglikelihood([("a", "bcd"), ("ab", "c")]),
                lm.greedy_until([("prompt", ["\n"])]), calls)

    assert textsynth(t_remote) == textsynth(j_remote)
    sleeps = ([], [])
    for mod, s in zip((t_remote, j_remote), sleeps):
        n = {"k": 0}

        def flaky():
            n["k"] += 1
            if n["k"] < 4:
                raise ConnectionError("down")
            return n["k"]

        assert mod.retry_with_backoff(flaky, sleeper=s.append) == 4
    assert sleeps[0] == sleeps[1] == [3.0, 4.5, 6.75]
