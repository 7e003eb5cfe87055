"""Token samplers (port of ``rten_tpu/generate/sampler.py``). This slice is
greedy-only; the per-request samplers come with ROADMAP.md Queue 1, serving
breadth: samplers, and will take explicit ``torch.Generator``s."""

from __future__ import annotations

from dataclasses import dataclass

import torch


class Sampler:
    def sample(self, logits):
        """logits: [vocab] or [batch, vocab] → int32 token id(s)."""
        raise NotImplementedError


@dataclass
class ArgMaxSampler(Sampler):
    def sample(self, logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)
