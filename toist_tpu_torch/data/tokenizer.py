"""Byte-level BPE tokenizer with char->token offsets (host data pipeline).

The port's own copy of ``toist_tpu/data/tokenizer.py``, kept line for line so that it
diffs against it (the port imports nothing of the JAX package).

Replaces the reference's HF Rust RobertaTokenizerFast (models/transformer.py:59,
datasets/tdod.py:296). Encoding runs in C++ (toist_native.bpe_encode); this wrapper
handles vocab management, special tokens, and the char_to_token mapping the
positive-map machinery depends on (datasets/tdod.py:150-176).

Two ways to get a vocab:
  * ``RobertaBPE.from_pretrained_files(vocab_json, merges_txt)`` — exact roberta-base
    vocab when the HF files are available on disk (parity path).
  * ``RobertaBPE.train(corpus, vocab_size)`` — a tiny deterministic BPE trainer for
    the closed COCO-Tasks caption vocabulary (offline path; this image has no HF
    cache and no network).

Offsets are leading-whitespace-trimmed like RoBERTa's trim_offsets=True, so
``char_to_token`` on a space returns None and the reference's +-1/2/3-char probing
(replicated in data/positive_map.py) behaves identically.
"""
from __future__ import annotations

import ctypes
import json
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from toist_tpu_torch import native

# RoBERTa special-token convention.
BOS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
SPECIALS = {"<s>": BOS_ID, "<pad>": PAD_ID, "</s>": EOS_ID, "<unk>": UNK_ID}


def _byte_to_unicode() -> Dict[int, str]:
    """GPT-2's printable byte->unicode table (public spec)."""
    keep = (list(range(33, 127)) + list(range(161, 173)) +
            list(range(174, 256)))
    table = {}
    n = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


_B2U = _byte_to_unicode()


class Tokenized:
    """Result of encoding one caption; mimics the slice of the HF API we need."""

    def __init__(self, ids: List[int], starts: List[int], ends: List[int],
                 text: str):
        # ids/starts/ends EXCLUDE specials; input_ids adds <s> ... </s>.
        self.body_ids = ids
        self.starts = starts
        self.ends = ends
        self.text = text
        self.input_ids = [BOS_ID] + ids + [EOS_ID]

    def __len__(self):
        return len(self.input_ids)

    def char_to_token(self, char_idx: int) -> Optional[int]:
        """Token index (counting <s> at 0) covering this char, else None."""
        for i, (s, e) in enumerate(zip(self.starts, self.ends)):
            if s <= char_idx < e:
                return i + 1
        return None


class RobertaBPE:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        vocab_txt = "".join(f"{t}\t{i}\n" for t, i in self.vocab.items())
        merges_txt = "".join(f"{a} {b}\n" for a, b in self.merges)
        self._lib = native.load()
        self._handle = self._lib.bpe_create(
            vocab_txt.encode(), merges_txt.encode(), UNK_ID)
        if self._handle < 0:
            raise RuntimeError("bpe_create failed")

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1

    def encode(self, text: str, max_tokens: int = 512) -> Tokenized:
        ids = np.empty(max_tokens, np.int32)
        starts = np.empty(max_tokens, np.int32)
        ends = np.empty(max_tokens, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.bpe_encode(
            self._handle, text.encode(), ids.ctypes.data_as(i32p),
            starts.ctypes.data_as(i32p), ends.ctypes.data_as(i32p), max_tokens)
        if n < 0:
            raise RuntimeError("bpe_encode failed")
        starts, ends = starts[:n].tolist(), ends[:n].tolist()
        if len(text.encode()) != len(text):
            # Non-ASCII text: the C++ core reports BYTE offsets; callers index
            # Python strings, so map them to char offsets (HF fast tokenizers
            # report char offsets too — the parity oracle in
            # tests/test_tokenizer_parity.py).
            char_of_byte = []  # containing char index for every byte
            for ci, ch in enumerate(text):
                char_of_byte.extend([ci] * len(ch.encode()))
            nb = len(char_of_byte)
            # Starts floor to the containing char; ends round up past it (a
            # token ending mid-char still covers that char, like HF).
            starts = [char_of_byte[min(s, nb - 1)] for s in starts]
            ends = [char_of_byte[min(e, nb) - 1] + 1 if e > 0 else 0
                    for e in ends]
        return Tokenized(ids[:n].tolist(), starts, ends, text)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_pretrained_files(cls, vocab_json: str, merges_txt: str) -> "RobertaBPE":
        with open(vocab_json) as f:
            vocab = json.load(f)
        merges = []
        with open(merges_txt) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def train(cls, corpus: Sequence[str], vocab_size: int = 1024) -> "RobertaBPE":
        """Deterministic byte-level BPE training on a small corpus."""
        # Pre-tokenize with the same ASCII-scope rules as the C++ encoder:
        # split words keeping the leading space attached.
        words: Counter = Counter()
        for text in corpus:
            for w in _simple_pretokenize(text):
                units = tuple(_B2U[b] for b in w.encode("utf-8"))
                words[units] += 1

        merges: List[Tuple[str, str]] = []
        vocab: Dict[str, int] = dict(SPECIALS)
        next_id = max(vocab.values()) + 1
        # Byte alphabet first (all 256 units for robustness to unseen input).
        for b in range(256):
            u = _B2U[b]
            if u not in vocab:
                vocab[u] = next_id
                next_id += 1

        work = dict(words)
        while next_id < vocab_size:
            pairs: Counter = Counter()
            for units, cnt in work.items():
                for a, b in zip(units, units[1:]):
                    pairs[(a, b)] += cnt
            if not pairs:
                break
            # Deterministic: max count, ties by lexicographic pair.
            best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
            merges.append(best)
            merged = best[0] + best[1]
            if merged not in vocab:
                vocab[merged] = next_id
                next_id += 1
            new_work = {}
            for units, cnt in work.items():
                out = []
                i = 0
                while i < len(units):
                    if (i + 1 < len(units) and units[i] == best[0]
                            and units[i + 1] == best[1]):
                        out.append(merged)
                        i += 2
                    else:
                        out.append(units[i])
                        i += 1
                new_work[tuple(out)] = new_work.get(tuple(out), 0) + cnt
            work = new_work
        return cls(vocab, merges)

    def save(self, vocab_json: str, merges_txt: str) -> None:
        with open(vocab_json, "w") as f:
            json.dump(self.vocab, f)
        with open(merges_txt, "w") as f:
            f.write("#version: toist\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")


def _is_letter(c: str) -> bool:
    import unicodedata
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    import unicodedata
    return unicodedata.category(c).startswith("N")


def _simple_pretokenize(text: str) -> List[str]:
    """Python mirror of the C++ pre-tokenizer (for BPE training only):
    the GPT-2 regex with exact \\p{L}/\\p{N} classes, including the
    contraction literals."""
    out = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == "'":
            matched = next((s for s in ("'re", "'ve", "'ll", "'s", "'t",
                                        "'m", "'d")
                            if text.startswith(s, i)), None)
            if matched:
                out.append(matched)
                i += len(matched)
                continue
        j = i
        if text[j] == " " and j + 1 < n and not text[j + 1].isspace():
            j += 1
        if j < n and _is_letter(text[j]):
            k = j
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(text[i:k]); i = k
        elif j < n and _is_number(text[j]):
            k = j
            while k < n and _is_number(text[k]):
                k += 1
            out.append(text[i:k]); i = k
        elif text[i].isspace():
            k = i
            while k < n and text[k].isspace():
                k += 1
            if k < n and k - i > 1:
                k -= 1
            k = max(k, i + 1)
            out.append(text[i:k]); i = k
        else:
            k = j
            while k < n and not (text[k].isspace() or _is_letter(text[k])
                                 or _is_number(text[k])):
                k += 1
            out.append(text[i:k]); i = k
    return out
