"""CTC decoding: greedy + beam search (a copy of ``rten_tpu/ctc.py``;
host-side numpy, after the reference's src/ctc.rs:26-211).

Input: per-timestep log-probabilities [steps, classes] with class 0 as
the CTC blank (matching the reference's convention)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

BLANK = 0


@dataclass
class CtcHypothesis:
    steps: list = field(default_factory=list)   # (label, time) pairs
    score: float = 0.0

    def labels(self) -> list[int]:
        return [label for label, _ in self.steps]


def ctc_greedy_decode(log_probs) -> CtcHypothesis:
    """Best-path decoding: argmax per step, collapse repeats, drop blanks."""
    lp = np.asarray(log_probs)
    best = lp.argmax(axis=1)
    hyp = CtcHypothesis()
    prev = BLANK
    for t, label in enumerate(best):
        hyp.score += float(lp[t, label])
        if label != BLANK and label != prev:
            hyp.steps.append((int(label), t))
        prev = label
    return hyp


def ctc_beam_search_decode(log_probs, beam_size=10) -> list[CtcHypothesis]:
    """Prefix beam search (log domain). Returns hypotheses best-first."""
    lp = np.asarray(log_probs)
    n_steps, n_classes = lp.shape

    def logsumexp(a, b):
        if a == -math.inf:
            return b
        if b == -math.inf:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    # prefix (tuple of (label, time)) → [p_blank, p_nonblank]
    beams = {(): [0.0, -math.inf]}
    for t in range(n_steps):
        step = lp[t]
        new_beams: dict = {}

        def add(prefix, pb, pnb):
            cur = new_beams.setdefault(prefix, [-math.inf, -math.inf])
            cur[0] = logsumexp(cur[0], pb)
            cur[1] = logsumexp(cur[1], pnb)

        for prefix, (p_b, p_nb) in beams.items():
            total = logsumexp(p_b, p_nb)
            # blank extends both paths without changing the prefix
            add(prefix, total + float(step[BLANK]), -math.inf)
            for c in range(1, n_classes):
                p_c = float(step[c])
                last = prefix[-1][0] if prefix else None
                if c == last:
                    # repeat: extends non-blank only if a blank intervened
                    add(prefix, -math.inf, p_nb + p_c)
                    add(prefix + ((c, t),), -math.inf, p_b + p_c)
                else:
                    add(prefix + ((c, t),), -math.inf, total + p_c)
        ranked = sorted(new_beams.items(),
                        key=lambda kv: -logsumexp(*kv[1]))
        beams = dict(ranked[:beam_size])

    out = []
    for prefix, (p_b, p_nb) in sorted(
            beams.items(), key=lambda kv: -logsumexp(*kv[1])):
        hyp = CtcHypothesis(list(prefix), logsumexp(p_b, p_nb))
        out.append(hyp)
    return out
