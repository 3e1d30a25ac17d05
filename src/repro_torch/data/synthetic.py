"""Synthetic NLP-like classification tasks with *controllable difficulty*.

No dataset downloads: a keyword-detection
task in token space mirrors prompt-style classification: each class c
has a keyword token; a sequence contains the keyword planted among distractor
tokens, and the model must emit the class's *label token* as the next token
(exactly the "This is [MASK]" prompt-classification setup of App. E).

Per-sample ``noise`` ∈ [0,1] controls how few keyword copies appear — the
ground-truth difficulty, which lets tests validate that the Fisher difficulty
score correlates with a known quantity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

KEYWORD_BASE = 10  # token ids for class keywords
LABEL_BASE = 110  # token ids for class label tokens
DISTRACTOR_BASE = 220


@dataclasses.dataclass
class SyntheticTask:
    data: Dict[str, np.ndarray]  # tokens (N,S), label_token (N,), label (N,)
    noise: np.ndarray  # (N,) ground-truth difficulty
    n_classes: int
    vocab_size: int

    @property
    def n(self) -> int:
        return len(self.noise)

    def subset(self, idx: np.ndarray) -> "SyntheticTask":
        return SyntheticTask(
            data={k: v[idx] for k, v in self.data.items()},
            noise=self.noise[idx],
            n_classes=self.n_classes,
            vocab_size=self.vocab_size,
        )


def make_keyword_task(
    *,
    n_samples: int,
    seq_len: int,
    vocab_size: int,
    n_classes: int = 4,
    max_noise: float = 0.9,
    seed: int = 0,
) -> SyntheticTask:
    assert vocab_size > DISTRACTOR_BASE + 10
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_samples)
    noise = rng.uniform(0.0, max_noise, n_samples)
    tokens = rng.integers(DISTRACTOR_BASE, vocab_size, (n_samples, seq_len))
    # wrong-class keywords as hard distractors, density grows with noise
    for i in range(n_samples):
        n_distract = int(noise[i] * seq_len * 0.15)
        if n_distract:
            pos = rng.choice(seq_len, n_distract, replace=False)
            wrong = (labels[i] + 1 + rng.integers(0, n_classes - 1, n_distract)) % n_classes
            tokens[i, pos] = KEYWORD_BASE + wrong
        n_kw = max(1, int(round((1.0 - noise[i]) * seq_len * 0.2)))
        pos = rng.choice(seq_len, min(n_kw, seq_len), replace=False)
        tokens[i, pos] = KEYWORD_BASE + labels[i]
    return SyntheticTask(
        data={
            "tokens": tokens.astype(np.int32),
            "label_token": (LABEL_BASE + labels).astype(np.int32),
            "label": labels.astype(np.int32),
        },
        noise=noise,
        n_classes=n_classes,
        vocab_size=vocab_size,
    )
