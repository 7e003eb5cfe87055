"""Token samplers (port of ``rten_tpu/generate/sampler.py``): argmax,
top-k and top-p with a temperature, and the per-request sampler whose knobs
are per-row tensors.

Sampling runs on the logits' device and draws from an explicit
``torch.Generator`` on that device (``generator``; None draws from the
device's default generator). Categorical draws are Gumbel-max, as
``jax.random.categorical`` draws them, so the distributions are the
reference's; the random streams are not, and sampled ids are never
compared across the two packages. Greedy rows take ``torch.argmax``, which
returns the lowest index among equal maxima, as ``lax.top_k``'s first
index does. Top-k candidates come from
:func:`~rten_tpu_torch.utils.topk.ordered_top_k`, so equal logits keep
``lax.top_k``'s order, lowest index first, also at the k-th place
(``torch.topk`` over the logits themselves orders equal values arbitrarily
on CUDA).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.topk import ordered_top_k


def _gumbel_argmax(logits, generator):
    """One categorical draw per row of ``logits`` [..., N] (-inf masks an
    entry): argmax(logits + Gumbel noise)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))
    return torch.argmax(logits.to(torch.float32) + g, dim=-1)


class Sampler:
    def sample(self, logits, generator=None):
        """logits: [vocab] or [batch, vocab] → int32 token id(s)."""
        raise NotImplementedError


@dataclass
class ArgMaxSampler(Sampler):
    def sample(self, logits, generator=None):
        return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclass
class TopKSampler(Sampler):
    k: int = 50
    temperature: float = 1.0

    def sample(self, logits, generator=None):
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        values, indices = ordered_top_k(logits, self.k)
        choice = _gumbel_argmax(values / self.temperature, generator)
        return torch.gather(indices, -1, choice[..., None])[..., 0].to(
            torch.int32)


@dataclass
class TopPSampler(Sampler):
    p: float = 0.9
    temperature: float = 1.0

    def sample(self, logits, generator=None):
        if self.temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits / self.temperature, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= p (always keep
        # the first token).
        cutoff_mask = cum - sorted_probs >= self.p
        threshold = torch.where(cutoff_mask, torch.inf,
                                sorted_logits).amin(dim=-1, keepdim=True)
        masked = torch.where(logits >= threshold, logits / self.temperature,
                             -torch.inf)
        return _gumbel_argmax(masked, generator).to(torch.int32)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (carried as per-row tensors through the
    decode step — see PerRequestSampler)."""
    temperature: float = 1.0
    top_k: int = 0       # 0 = no top-k cut
    top_p: float = 1.0   # 1 = no nucleus cut

    GREEDY = None  # set below


SamplingParams.GREEDY = SamplingParams(temperature=0.0)


@dataclass
class PerRequestSampler(Sampler):
    """Vectorized sampler whose temperature/top-k/top-p are PER-ROW
    tensors, so a continuous batch mixes greedy and stochastic requests in
    one decode step with no per-request branch on the host.

    Candidates are each row's top ``max_k`` logits: exact for
    ``top_k <= max_k``; top-p nucleus is computed within those
    candidates (exact whenever the nucleus fits in ``max_k``, i.e.
    except for near-uniform tails). ``temperature <= 0`` → greedy.
    """

    max_k: int = 64

    def sample(self, logits, temps, top_ks, top_ps, generator=None):
        """logits [B, V]; temps/top_ks/top_ps f32 [B] on the logits' device
        → int32 tokens [B]."""
        k_eff = torch.where(top_ks <= 0, float(self.max_k),
                            torch.clamp(top_ks, max=float(self.max_k)))
        values, indices = ordered_top_k(logits, self.max_k)
        ranks = torch.arange(self.max_k, device=logits.device)[None, :]
        mask_k = ranks < k_eff[:, None]
        scaled = values / torch.clamp(temps, min=1e-6)[:, None]
        probs = torch.softmax(torch.where(mask_k, scaled, -torch.inf),
                              dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Smallest prefix whose mass reaches top_p (first always kept).
        mask_p = (cum - probs) < top_ps[:, None]
        final = torch.where(mask_k & mask_p, scaled, -torch.inf)
        choice = _gumbel_argmax(final, generator)
        sampled = torch.gather(indices, 1, choice[:, None])[:, 0]
        greedy = torch.argmax(logits, dim=-1)
        return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)
