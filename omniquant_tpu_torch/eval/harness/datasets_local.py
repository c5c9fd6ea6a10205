"""Offline raw-file dataset loaders (reference lm_eval/datasets/* — 14 HF
loading scripts). In a zero-egress deployment the HF hub is unreachable, so
these loaders parse the same raw artifacts the reference's builders download
(the user fetches them once out of band) and return split dicts in exactly
the shape the task classes consume — pass the result as
``simple_evaluate(..., task_data={name: load_x(path)})``.

Each loader mirrors the corresponding reference builder's parsing logic
(file:function cited per loader); no HF `datasets` machinery is required.
"""
from __future__ import annotations

import csv
import glob
import json
import os
from typing import Dict, List


def load_logiqa(train_path=None, validation_path=None, test_path=None):
    """Blocks of 'label\\ncontext\\nquestion\\noptions×4' separated by blank
    lines (reference datasets/logiqa/logiqa.py:_generate_examples)."""
    def normalize(text):
        return text.replace(".", ". ").strip()

    def parse(path):
        if path is None:
            return []
        out = []
        with open(path, encoding="utf-8") as f:
            for row in f.read().strip().split("\n\n"):
                lines = row.split("\n")
                out.append({
                    "label": lines[0].strip(),
                    "context": normalize(lines[1]),
                    "question": normalize(lines[2]),
                    "options": [normalize(o[2:]) for o in lines[3:]],
                })
        return out

    return {"train": parse(train_path), "validation": parse(validation_path),
            "test": parse(test_path)}


def load_mutual(data_dir, subset="mutual"):
    """MuTual repo checkout: data/{subset}/{train,dev,test}/*.txt, each a
    JSON object (reference datasets/mutual/mutual.py:_generate_examples)."""
    def parse(split):
        base = os.path.join(data_dir, "data", subset, split)
        out = []
        for fn in sorted(glob.glob(os.path.join(base, "*.txt"))):
            with open(fn, encoding="utf-8") as f:
                text = f.read()
            if not text:
                continue
            data = json.loads(text)
            out.append({"article": data["article"],
                        "options": data["options"],
                        "answers": data["answers"]})
        return out

    return {"train": parse("train"), "validation": parse("dev"),
            "test": parse("test")}


def load_unscramble(jsonl_path):
    """GPT-3 unscramble jsonl: {context, completion} per line (reference
    datasets/unscramble/unscramble.py:_generate_examples)."""
    out = []
    with open(jsonl_path, encoding="utf-8") as f:
        for row in f:
            data = json.loads(row)
            out.append({"context": data["context"],
                        "completion": data["completion"]})
    return {"validation": out}


def load_asdiv(xml_path):
    """ASDiv.xml Problem elements (reference datasets/asdiv/asdiv.py)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    out = []
    for problem in root.iter("Problem"):
        out.append({
            "body": problem.find("Body").text,
            "question": problem.find("Question").text,
            "solution_type": problem.find("Solution-Type").text,
            "answer": problem.find("Answer").text,
            "formula": problem.find("Formula").text,
        })
    return {"validation": out}


def load_sat_analogies(txt_path):
    """SAT-package-V3.txt records (reference datasets/sat_analogies)."""
    records: List[List[str]] = []
    with open(txt_path, encoding="utf-8") as f:
        record: List[str] = []
        for line in f:
            line = line.strip()
            if not line and record:
                records.append(record)
                record = []
            elif line and line[0] == "#":
                continue
            elif line:
                record.append(line)
        if record:
            records.append(record)
    out = []
    for record in records:
        out.append({
            "source": record[-8],
            "stem": record[-7],
            "choices": record[-6:-1],
            "solution": record[-1],
        })
    return {"validation": out}


def load_headqa(train_json, validation_json=None, test_json=None):
    """HEAD-QA exam json (reference datasets/headqa/headqa.py)."""
    def parse(path):
        if path is None:
            return []
        with open(path, encoding="utf-8") as f:
            head_qa = json.load(f)
        out = []
        for exam in head_qa["exams"]:
            for question in head_qa["exams"][exam]["data"]:
                out.append({
                    "qid": int(question["qid"].strip()),
                    "qtext": question["qtext"].strip(),
                    "ra": int(question["ra"].strip()),
                    "answers": [
                        {"aid": a["aid"], "atext": a["atext"].strip()}
                        for a in question["answers"]
                    ],
                })
        return out

    return {"train": parse(train_json), "validation": parse(validation_json),
            "test": parse(test_json)}


def load_coqa(train_json=None, validation_json=None):
    """coqa-{train,dev}-v1.0.json (reference datasets/coqa/coqa.py)."""
    def parse(path):
        if path is None:
            return []
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        out = []
        for row in data["data"]:
            questions = {"input_text":
                         [q["input_text"] for q in row["questions"]]}
            answers = {"input_text":
                       [a["input_text"] for a in row["answers"]]}
            additional = {}
            for key, answer_list in (row.get("additional_answers")
                                     or {}).items():
                additional[key] = {"input_text":
                                   [a["input_text"] for a in answer_list]}
            out.append({"story": row["story"], "questions": questions,
                        "answers": answers,
                        "additional_answers": additional or None})
        return out

    return {"train": parse(train_json), "validation": parse(validation_json)}


def load_drop(train_json=None, validation_json=None):
    """drop_dataset_{train,dev}.json (reference datasets/drop/drop.py)."""
    def norm_answer(answer):
        return {
            "number": answer["number"],
            "date": {
                "day": answer["date"].get("day", ""),
                "month": answer["date"].get("month", ""),
                "year": answer["date"].get("year", ""),
            } if answer.get("date") else {"day": "", "month": "", "year": ""},
            "spans": answer["spans"],
        }

    def parse(path):
        if path is None:
            return []
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        out = []
        for example in data.values():
            for qa in example["qa_pairs"]:
                validated = qa.get("validated_answers") or []
                out.append({
                    "query_id": qa["query_id"],
                    "passage": example["passage"],
                    "question": qa["question"],
                    "answer": norm_answer(qa["answer"]),
                    "validated_answers": {
                        "number": [v["number"] for v in validated],
                        "date": [norm_answer(v)["date"] for v in validated],
                        "spans": [v["spans"] for v in validated],
                    },
                })
        return out

    return {"train": parse(train_json), "validation": parse(validation_json)}


def load_triviaqa(train_json=None, validation_json=None):
    """unfiltered-web-{train,dev}.json (reference datasets/triviaqa)."""
    def parse(path):
        if path is None:
            return []
        with open(path, encoding="utf-8") as f:
            rows = json.load(f)["Data"]
        out = []
        for data in rows:
            out.append({
                "question": data["Question"],
                "answer": {
                    "value": data["Answer"]["Value"],
                    "aliases": data["Answer"]["Aliases"],
                },
            })
        return out

    return {"train": parse(train_json), "validation": parse(validation_json)}


def load_quac(train_json=None, validation_json=None):
    """QuAC v0.2 json (reference datasets/quac/quac.py)."""
    def parse(path):
        if path is None:
            return []
        with open(path, encoding="utf-8") as f:
            data = json.load(f)["data"]
        out = []
        for row in data:
            paragraph = row["paragraphs"][0]["context"].replace(
                "CANNOTANSWER", "")
            for qa in row["paragraphs"][0]["qas"]:
                out.append({
                    "title": row["title"],
                    "section_title": row["section_title"],
                    "paragraph": paragraph,
                    "question": qa["question"],
                    "answer": qa["answers"][0]["text"],
                })
        return out

    return {"train": parse(train_json), "validation": parse(validation_json)}


_ETHICS_PREFIX = {"commonsense": "cm", "deontology": "deontology",
                  "justice": "justice", "utilitarianism": "util",
                  "virtue": "virtue"}


def load_hendrycks_ethics(data_dir, subset):
    """ethics/{subset}/{prefix}_{train,test}.csv (reference
    datasets/hendrycks_ethics); group_id synthesized for deontology/justice
    (groups of 4) and virtue (groups of 5) as in the builder."""
    prefix = _ETHICS_PREFIX[subset]
    group_of = {"deontology": 4, "justice": 4, "virtue": 5}.get(subset)

    def parse(split):
        path = os.path.join(data_dir, "ethics", subset,
                            f"{prefix}_{split}.csv")
        if not os.path.exists(path):
            return []
        out = []
        with open(path, newline="", encoding="utf-8") as f:
            if subset == "utilitarianism":
                reader = csv.DictReader(
                    f, fieldnames=["activity", "baseline"])
            else:
                reader = csv.DictReader(f)
            for i, row in enumerate(reader):
                row = dict(row)
                if subset == "virtue" and "scenario" in row:
                    # virtue rows are "scenario [SEP] trait"
                    parts = row["scenario"].split(" [SEP] ")
                    if len(parts) == 2:
                        row["scenario"], row["trait"] = parts
                if group_of:
                    row["group_id"] = i // group_of
                out.append(row)
        return out

    return {"train": parse("train"), "test": parse("test")}


def load_hendrycks_math(data_dir, subject):
    """MATH/{train,test}/{subject}/*.json (reference
    datasets/hendrycks_math)."""
    def parse(split):
        base = os.path.join(data_dir, "MATH", split, subject)
        out = []
        for fn in sorted(glob.glob(os.path.join(base, "*.json"))):
            with open(fn, encoding="utf-8") as f:
                data = json.load(f)
            out.append({"problem": data["problem"], "level": data["level"],
                        "type": data["type"], "solution": data["solution"]})
        return out

    return {"train": parse("train"), "test": parse("test")}


def load_pile_subset(jsonl_path, subset_name, split="test"):
    """The Pile val/test jsonl filtered by meta.pile_set_name (reference
    datasets/pile/pile.py). `subset_name` is the human name, e.g.
    'Github' or 'Pile-CC'."""
    out = []
    with open(jsonl_path, encoding="utf-8") as f:
        for row in f:
            data = json.loads(row)
            if data["meta"]["pile_set_name"] == subset_name:
                out.append(data["text"])
    return {split: out, ("validation" if split == "test" else "test"): []}


# human-readable Pile subset names keyed by our task suffix (reference
# datasets/pile/pile.py _NAMES)
PILE_SET_NAMES: Dict[str, str] = {
    "arxiv": "ArXiv", "books3": "Books3", "bookcorpus2": "BookCorpus2",
    "dm-mathematics": "DM Mathematics", "enron": "Enron Emails",
    "europarl": "EuroParl", "freelaw": "FreeLaw", "github": "Github",
    "gutenberg": "Gutenberg (PG-19)", "hackernews": "HackerNews",
    "nih-exporter": "NIH ExPorter", "opensubtitles": "OpenSubtitles",
    "openwebtext2": "OpenWebText2", "philpapers": "PhilPapers",
    "pile-cc": "Pile-CC", "pubmed-abstracts": "PubMed Abstracts",
    "pubmed-central": "PubMed Central", "stackexchange": "StackExchange",
    "uspto": "USPTO Backgrounds", "ubuntu-irc": "Ubuntu IRC",
    "wikipedia": "Wikipedia (en)", "youtubesubtitles": "YoutubeSubtitles",
}
