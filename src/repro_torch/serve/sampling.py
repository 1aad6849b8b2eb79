"""Per-request sampling over a batch of slots.

Port of `repro/serve/sampling.py`.  Every decoding slot carries its own
(temperature, top_k, top_p, generator); `sample` applies all of them to
one batch of logits.  Greedy rows (temperature <= 0) take the exact
argmax, and an all-greedy batch touches no generator at all.

Generators are per request (seeded from `SamplingParams.seed`, or from
the engine seed and the request id), so a request's stream does not
depend on its batch neighbours or its slot.  The streams differ from
the reference's jax.random keys; what carries over is greedy identity
and the filters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode-time sampling controls.

    temperature <= 0 means greedy (argmax); top_k <= 0 and top_p >= 1
    disable their filters.  `stop` lists extra stop-token ids (the
    engine's eos_id always stops); `seed` pins the request's stream
    (None: derived from the engine seed and the request id).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: Tuple[int, ...] = ()
    seed: Optional[int] = None


def filter_logits(logits, top_k, top_p):
    """Mask logits outside the per-row top-k / nucleus (top-p) sets.

    logits: (B, V) f32; top_k: (B,) int (<= 0 disables); top_p: (B,)
    f32 (>= 1 disables).  Returns (B, V) with filtered entries at -inf.
    The top-1 token always survives.
    """
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values       # (B, V)
    k_eff = torch.where(top_k > 0, top_k.clamp(max=v),
                        torch.full_like(top_k, v)).long()
    kth = torch.gather(desc, -1, (k_eff - 1)[:, None])              # (B, 1)
    keep = logits >= kth
    # nucleus: keep tokens while the EXCLUSIVE cumulative mass < p, so
    # the first token is always kept and mass crosses p inclusively
    probs = torch.softmax(desc, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    p_eff = torch.where(top_p >= 1.0, torch.full_like(top_p, 2.0), top_p)
    kept_sorted = excl < p_eff[:, None]
    kept_sorted[:, 0] = True                 # top-1 survives p=0
    thresh = torch.where(kept_sorted, desc,
                         torch.full_like(desc, float("inf"))).amin(-1)
    keep = keep & (logits >= thresh[:, None])
    return torch.where(keep, logits, torch.full_like(logits, -float("inf")))


def sample(logits, generators: Sequence[Optional[torch.Generator]],
           temperature, top_k, top_p):
    """One sampling step for a batch of slots.

    logits: (B, V); generators: one per row (None where the row is
    greedy); temperature / top_p: (B,) f32 and top_k: (B,) int, on the
    host.  Returns (B,) int64 tokens on the logits' device.
    """
    greedy = torch.argmax(logits, dim=-1)
    sampled = temperature > 0
    if not bool(sampled.any()):
        return greedy
    dev = logits.device
    filt = filter_logits(logits.float(), top_k.to(dev), top_p.to(dev))
    scaled = filt / temperature.to(dev).clamp(min=1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    out = greedy.clone()
    for row in torch.nonzero(sampled).flatten().tolist():
        out[row] = torch.multinomial(probs[row], 1,
                                     generator=generators[row])[0]
    return out


def request_generator(sp: SamplingParams, engine_seed: int, rid: int,
                      device) -> torch.Generator:
    """The request's own generator: its seed, or engine seed x rid."""
    gen = torch.Generator(device=device)
    if sp.seed is not None:
        gen.manual_seed(sp.seed)
    else:
        gen.manual_seed(((engine_seed & 0xFFFFFFFF) << 32)
                        | (rid & 0xFFFFFFFF))
    return gen
