"""Captions and tokenizer for the serving path.

``build_tokenizer`` is a copy of ``toist_tpu/main.py:build_tokenizer``.
The task phrases (``TASKS``) come from the port's copy of
``data/cocotasks.py``; that module imports PIL, so they are imported where
they are used, not at module level.
"""
from __future__ import annotations

import json
import os

from toist_tpu_torch.config import Config
from toist_tpu_torch.data.tokenizer import RobertaBPE


def task_caption(task_id: int) -> str:
    """The student's pronoun caption for a task ("verb something")."""
    from toist_tpu_torch.data.cocotasks import TASKS

    return TASKS[task_id] + "something"


def build_tokenizer(cfg: Config) -> RobertaBPE:
    """HF roberta-base vocab files if available, else a BPE trained on every
    caption this dataset can produce."""
    from toist_tpu_torch.data.cocotasks import TASKS

    ann = cfg.data.refexp_ann_path
    vocab_json = os.path.join(ann, "vocab.json") if ann else ""
    merges_txt = os.path.join(ann, "merges.txt") if ann else ""
    if vocab_json and os.path.exists(vocab_json) and os.path.exists(merges_txt):
        return RobertaBPE.from_pretrained_files(vocab_json, merges_txt)
    corpus = [t + "something" for t in TASKS.values()]
    id2name = os.path.join(ann, "id2name.json") if ann else ""
    if id2name and os.path.exists(id2name):
        with open(id2name) as f:
            names = list(json.load(f).values())
        corpus += [t + n for t in TASKS.values() for n in names]
    return RobertaBPE.train(corpus, vocab_size=2048)
