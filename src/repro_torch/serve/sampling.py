"""Batched sampling for the port's serve engine (counterpart of the JAX
``repro.serve.sampling``).

Greedy rows take argmax.  Rows with temperature > 0 draw from the filtered
distribution with a generator seeded from that row's ``(seed, step)`` alone,
so a request's stream never depends on which other requests share its
batch.  The draws cannot equal ``jax.random``'s.
"""
from __future__ import annotations

import numpy as np
import torch


def filtered_probs(logits, temperature, top_k, top_p):
    """Per-row filtered distribution.  logits (B, V); temperature, top_k,
    top_p (B,).  ``top_k == 0`` skips top-k, ``top_p >= 1`` skips the
    nucleus; greedy rows (temperature <= 0) use temperature 1 here only to
    keep the softmax finite.  Returns (B, V) rows summing to 1."""
    v = logits.shape[-1]
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))[:, None]
    x = logits.float() / t
    k = top_k.long().clamp(0, v)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k - 1).clamp(min=0)[:, None])
    x = torch.where((k[:, None] > 0) & (x < kth),
                    torch.full_like(x, float("-inf")), x)
    p = torch.softmax(x, dim=-1)
    # nucleus: keep a token iff the mass before it (descending) is < top_p
    p_sorted, order = torch.sort(p, dim=-1, descending=True)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < top_p[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    keep = keep | (top_p[:, None] >= 1.0)
    p = torch.where(keep, p, torch.zeros_like(p))
    return p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def _row_generator(seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def sample_batch(logits, temperature, top_k, top_p, seeds, steps):
    """(B, V) logits -> (B,) int32 ids.  temperature/top_k/top_p/seeds/steps
    are (B,) tensors on the logits' device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    hot = (temperature > 0).nonzero().flatten().tolist()
    if not hot:
        return greedy
    p = filtered_probs(logits, temperature, top_k, top_p)
    out = greedy.clone()
    seeds, steps = seeds.tolist(), steps.tolist()
    for i in hot:
        gen = _row_generator(seeds[i], steps[i], logits.device)
        out[i] = torch.multinomial(p[i], 1, generator=gen)[0].to(torch.int32)
    return out
