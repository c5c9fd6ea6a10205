"""The evaluation harness: counterpart of ``omniquant_tpu/eval/harness``
(its tasks, metrics, evaluator and caches, copied), with ``TorchLM`` in
place of ``JaxLM``."""
from .base import (
    LM,
    MultipleChoiceTask,
    PerplexityTask,
    Reorderer,
    Request,
    Task,
    TorchLM,
    get_rolling_token_windows,
    make_disjoint_window,
    rf,
)
from .caching import CachingLM, DummyLM
from .remote import OpenAICompletionLM, TextSynthStyleLM
from .categories import mmlu_rollup, subcategories, categories
from .evaluator import evaluate, get_task_dict, make_table, pattern_match, simple_evaluate
from .tasks import TASK_REGISTRY


def run_tasks(family, params, model_cfg, tokenizer, tasks, num_fewshot=0,
              limit=None, spec=None, seqlen=2048, batch_size=4, logger=None,
              task_data=None, cache_db=None, cache_fingerprint="",
              device="cuda", dtype=None):
    """The CLI's --tasks entry: build a TorchLM on ``device``, run
    simple_evaluate, roll up MMLU categories when present. cache_db
    (opt-in): sqlite path wrapping the LM in CachingLM so re-runs skip
    already-scored requests; cache_fingerprint identifies the model+scheme
    so a shared db can't serve another config's scores. dtype is
    TorchLM's."""
    lm = TorchLM(family, params, model_cfg, tokenizer, seqlen=seqlen,
                 batch_size=batch_size, spec=spec, device=device,
                 dtype=dtype)
    if cache_db:
        lm = CachingLM(lm, cache_db, fingerprint=cache_fingerprint)
    results = simple_evaluate(
        lm, tasks, num_fewshot=num_fewshot, limit=limit, task_data=task_data)
    if logger:
        logger.info("\n" + make_table(results))
    rollup = mmlu_rollup(results["results"])
    if rollup:
        results["results"].update(rollup)
        if logger:
            for k, v in rollup.items():
                logger.info(f"{k}: {v:.4f}")
    return results
