"""Self-speculative decoding (port of ``rten_tpu/generate/speculative.py``):
n-gram prompt-lookup drafts and chunked verification.

Each step drafts ``k`` tokens per sequence by matching its trailing n-gram
against its own history, verifies them in one chunked forward
(:meth:`TransformerLM.verify_step`), and commits the longest prefix that
greedy decoding agrees with plus the model's own next token. Greedy output
is exactly the stream of plain decoding; only the number of steps shrinks.

Drafting, acceptance and the token history stay on the device: a step
reads nothing back to the host, so a burst of steps syncs once.
"""

from __future__ import annotations

import torch


def ngram_draft(history, hist_len, n: int, k: int):
    """Prompt-lookup drafting, vectorized over the batch
    (speculative.py:30-68).

    ``history`` [B, cap] int32: committed tokens per sequence (the first
    ``hist_len[b]`` are valid, the rest garbage). Finds the last position
    ``j < hist_len - n`` where ``history[j:j+n]`` equals the trailing
    n-gram and proposes the ``k`` tokens that followed it, the window
    clipped to the last valid token; a sequence with no match drafts its
    last token repeated. Returns drafts [B, k] int32."""
    b, cap = history.shape
    dev = history.device
    hist_len = hist_len.to(torch.int64)
    pos = torch.arange(cap, device=dev)
    tail_idx = torch.clamp(hist_len[:, None] - n
                           + torch.arange(n, device=dev)[None, :], 0, cap - 1)
    tail = torch.gather(history, 1, tail_idx)                      # [B, n]
    match = torch.ones((b, cap), dtype=torch.bool, device=dev)
    for i in range(n):
        # history[:, j + i] for every j, zero-padded past the end.
        shifted = torch.cat([history[:, i:], history.new_zeros((b, i))],
                            dim=1)
        match &= shifted == tail[:, i:i + 1]
    # j starts a full n-gram strictly before the trailing one, with at
    # least one continuation token inside the valid prefix.
    match &= pos[None, :] < hist_len[:, None] - n
    found = match.any(dim=1)
    # The last matching j: argmax over the reversed rows takes the first.
    j = cap - 1 - torch.argmax(match.flip(1).to(torch.int32), dim=1)
    draft_idx = (j + n)[:, None] + torch.arange(k, device=dev)[None, :]
    draft_idx = torch.minimum(torch.clamp(draft_idx, min=0),
                              hist_len[:, None] - 1)
    drafts = torch.gather(history, 1, draft_idx)
    last = torch.gather(history, 1,
                        torch.clamp(hist_len[:, None] - 1, 0, cap - 1))
    return torch.where(found[:, None], drafts, last).to(torch.int32)


def make_spec_burst(model, n_gram: int, k_draft: int):
    """The speculative burst (speculative.py:71-117): ``fn(params,
    history, cache, n_steps)`` → (history, cache, tokens int32
    [n, B, k+1], counts int32 [n, B], last committed token int32 [B]), all
    on the cache's device.

    Each step drafts ``k_draft`` tokens, verifies the last committed token
    and the drafts in one chunked forward, and accepts the agreeing prefix
    plus the bonus token (``counts``). ``history`` is updated in place with
    the step's whole greedy row at each sequence's committed length (the
    start clamped to ``cap - (k+1)``, as ``dynamic_update_slice`` clamps);
    the committed prefix is its first ``counts`` entries and the rest is
    overwritten before it becomes valid. Every slot advances by its count,
    finished ones included."""

    def burst(params, history, cache, n_steps: int):
        cap = history.shape[1]
        rows = torch.arange(history.shape[0], device=history.device)[:, None]
        cols = torch.arange(k_draft + 1, device=history.device)[None, :]
        toks, counts = [], []
        for _ in range(n_steps):
            hist_len = cache.lengths.to(torch.int64) + 1   # committed tokens
            drafts = ngram_draft(history, hist_len, n_gram, k_draft)
            last = torch.gather(history, 1,
                                torch.clamp(hist_len[:, None] - 1, 0,
                                            cap - 1))
            tokens = torch.cat([last, drafts], dim=1)      # [B, k+1]
            logits, cache = model.verify_step(params, tokens, cache)
            # argmax ties go to the lowest index, as jnp.argmax's do.
            greedy = torch.argmax(logits, dim=-1).to(torch.int32)
            ok = (drafts == greedy[:, :-1]).to(torch.int32)
            n_emit = torch.cumprod(ok, dim=1).sum(dim=1) + 1
            start = torch.clamp(hist_len, 0, cap - (k_draft + 1))
            history[rows, start[:, None] + cols] = greedy
            cache = cache.with_lengths(cache.lengths + n_emit)
            toks.append(greedy)
            counts.append(n_emit.to(torch.int32))
        toks, counts = torch.stack(toks), torch.stack(counts)
        last = torch.gather(toks[-1], 1, (counts[-1] - 1).to(
            torch.int64)[:, None])[:, 0]
        return history, cache, toks, counts, last

    return burst
