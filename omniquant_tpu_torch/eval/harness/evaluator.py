"""Evaluator: docs -> fewshot contexts -> batched LM calls -> metrics.

Re-design of the reference's modified evaluator (lm_eval/evaluator.py:18-314):
fnmatch task patterns, doc shuffle with seed 42, requests grouped by type
with ONE batched LM call per type, per-doc process_results, aggregation +
bootstrap stderr, and the markdown table writer.
"""
from __future__ import annotations

import collections
import fnmatch
import random
from typing import List, Optional

from .base import LM
from .metrics import stderr_for_metric
from .tasks import TASK_REGISTRY


def pattern_match(patterns, source_list):
    """reference lm_eval/evaluator.py:11-16."""
    task_names = set()
    for pattern in patterns:
        for matching in fnmatch.filter(source_list, pattern):
            task_names.add(matching)
    return sorted(task_names)


def get_task_dict(task_names, task_data: Optional[dict] = None):
    out = {}
    for name in task_names:
        ctor = TASK_REGISTRY[name]
        data = (task_data or {}).get(name)
        out[name] = ctor(data=data) if data is not None else ctor()
    return out


def simple_evaluate(lm: LM, tasks: List[str], num_fewshot: int = 0,
                    limit: Optional[int] = None,
                    task_data: Optional[dict] = None,
                    bootstrap_iters: int = 1000,
                    decontamination_train_path: Optional[str] = None,
                    decontamination_train_docs=None):
    task_names = pattern_match(tasks, TASK_REGISTRY.keys())
    if not task_names:
        raise ValueError(f"no tasks match {tasks}")
    task_dict = get_task_dict(task_names, task_data)
    results = evaluate(
        lm, task_dict, num_fewshot=num_fewshot, limit=limit,
        bootstrap_iters=bootstrap_iters,
        decontamination_train_path=decontamination_train_path,
        decontamination_train_docs=decontamination_train_docs)
    results["config"] = {
        "num_fewshot": num_fewshot,
        "limit": limit,
    }
    return results


def evaluate(lm: LM, task_dict: dict, num_fewshot: int = 0,
             limit: Optional[int] = None, bootstrap_iters: int = 1000,
             decontamination_train_path: Optional[str] = None,
             decontamination_train_docs=None):
    results = collections.defaultdict(dict)
    versions = {}

    # 13-gram train/test overlap filtering (reference lm_eval/evaluator.py:
    # 92,135,192-198,221-226): contaminated docs are excluded from a second
    # "<metric>_decontaminate" aggregation
    decontaminate = (decontamination_train_path is not None
                     or decontamination_train_docs is not None)
    docs_for_decontamination = collections.defaultdict(list)

    requests = collections.defaultdict(list)
    requests_origin = collections.defaultdict(list)
    docs = {}

    for task_name, task in task_dict.items():
        versions[task_name] = task.VERSION
        if task.has_test_docs():
            task_doc_func = task.test_docs
        elif task.has_validation_docs():
            task_doc_func = task.validation_docs
        else:
            raise RuntimeError(f"Task {task_name} has no valid docs")

        task_docs = list(task_doc_func())
        rnd = random.Random()
        rnd.seed(42)
        rnd.shuffle(task_docs)  # reference lm_eval/evaluator.py:179-181

        for doc_id, doc in enumerate(task_docs):
            if limit is not None and doc_id >= limit:
                break
            docs[(task_name, doc_id)] = doc
            if decontaminate and task.should_decontaminate():
                docs_for_decontamination[task_name].append(
                    task.doc_to_decontamination_query(doc))
            ctx = task.fewshot_context(
                doc=doc, num_fewshot=num_fewshot, rnd=rnd)
            reqs = task.construct_requests(doc, ctx)
            for i, req in enumerate(reqs):
                requests[req.request_type].append(req)
                requests_origin[req.request_type].append(
                    (i, task_name, doc, doc_id))

    # one batched LM call per request type (reference :224-237)
    process_res_queue = collections.defaultdict(list)
    for reqtype, reqs in requests.items():
        resps = getattr(lm, reqtype)([req.args for req in reqs])
        resps = [
            x if (req.index is None or not isinstance(x, tuple))
            else x[req.index]
            for x, req in zip(resps, reqs)
        ]
        for resp, (i, task_name, doc, doc_id) in zip(
                resps, requests_origin[reqtype]):
            process_res_queue[(task_name, doc_id)].append((i, resp))

    overlaps = {}
    if decontaminate and docs_for_decontamination:
        from ...decontamination import get_train_overlap

        overlaps = get_train_overlap(
            dict(docs_for_decontamination),
            train_docs=decontamination_train_docs,
            train_path=decontamination_train_path, limit=limit)

    vals = collections.defaultdict(list)
    for (task_name, doc_id), reqs in process_res_queue.items():
        reqs.sort(key=lambda x: x[0])
        reqs = [x[1] for x in reqs]
        task = task_dict[task_name]
        doc = docs[(task_name, doc_id)]
        metrics = task.process_results(doc, reqs)
        for metric, value in metrics.items():
            vals[(task_name, metric)].append(value)
            if (decontaminate and task_name in overlaps
                    and doc_id not in overlaps[task_name]):
                vals[(task_name, metric + "_decontaminate")].append(value)

    for (task_name, metric), items in vals.items():
        task = task_dict[task_name]
        base_metric = metric.removesuffix("_decontaminate")
        agg = task.aggregation()[base_metric]
        results[task_name][metric] = agg(items)
        stderr = stderr_for_metric(agg, bootstrap_iters)
        if stderr is not None:
            results[task_name][metric + "_stderr"] = stderr(items)

    return {"results": dict(results), "versions": versions}


def make_table(result_dict) -> str:
    """Markdown results table (reference lm_eval/evaluator.py:284-314)."""
    rows = ["|Task|Version|Metric|Value|Stderr|",
            "|---|---|---|---|---|"]
    for k, dic in sorted(result_dict["results"].items()):
        version = result_dict["versions"].get(k, "")
        for m, v in dic.items():
            if m.endswith("_stderr"):
                continue
            se = dic.get(m + "_stderr", "")
            se_s = f"{se:.4f}" if se != "" else ""
            rows.append(f"|{k}|{version}|{m}|{v:.4f}|{se_s}|")
    return "\n".join(rows)
