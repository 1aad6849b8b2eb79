"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch.

Port of the single-device path of `repro/models/moe.py` (`moe_init`,
`moe_apply` and `_shared_experts`; its expert-parallel `moe_apply_ep`
runs only under a mesh with a "model" axis and waits for the multi-GPU
slice, ROADMAP.md queue 1 item 11).  The dispatch never materializes a
(tokens, experts, capacity) one-hot: each (token, k) replica's slot in its
expert is an exclusive cumsum over the flattened (token, k) order, the
replicas are scattered into an (E * capacity + 1, d) buffer whose last
row takes the ones that overflow (the dump row), the experts run as one
batched SwiGLU, and the outputs are gathered back and summed with the
router's renormalized gates.  Shared experts (DeepSeek-V2, Moonlight) run
densely on every token, as plain products.  The Switch-style
load-balancing loss comes back beside the output.

The router is f32 whatever the param dtype, and its logits and softmax
are computed in f32.  The expert products are PyTorch products, as the
reference leaves them to XLA: the reference has no Pallas kernel here.

Capacity drops depend on every token of the call (the slot order runs
over all of them), so a call's result depends on its window of tokens,
as the reference's does; decode is dropless.  Routing is recomputed, not
saved, where the caller checkpoints (cfg.remat): the forward must give
the same top-k both times, and every step of it is deterministic on the
card but the scatter into the dump row, whose repeated indices leave it
holding any one of the dropped replicas; that row is discarded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init

F32 = torch.float32


def _expert_ffn_init(gen: torch.Generator, d_model: int, d_ff: int,
                     num: int, dtype=F32):
    """num stacked SwiGLU experts: wi, wg (E, d, f) and wo (E, f, d)."""
    def mk(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=F32,
                            device=gen.device) * scale).to(dtype)

    s_in, s_out = (1.0 / d_model) ** 0.5, (1.0 / d_ff) ** 0.5
    return {"wi": mk((num, d_model, d_ff), s_in),
            "wg": mk((num, d_model, d_ff), s_in),
            "wo": mk((num, d_ff, d_model), s_out)}


def moe_init(gen: torch.Generator, cfg, dtype=F32):
    """Router (always f32), the routed experts and the shared ones."""
    m = cfg.moe
    p = {"router": dense_init(gen, cfg.d_model, m.num_experts, dtype=F32),
         "experts": _expert_ffn_init(gen, cfg.d_model, m.d_expert,
                                     m.num_experts, dtype)}
    if m.num_shared:
        p["shared"] = _expert_ffn_init(gen, cfg.d_model, m.d_expert,
                                       m.num_shared, dtype)
    return p


def _batched_swiglu(p, x):
    """x: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    h = F.silu(torch.bmm(x, p["wg"].to(x.dtype))) * torch.bmm(
        x, p["wi"].to(x.dtype))
    return torch.bmm(h, p["wo"].to(x.dtype))


def capacity(cfg, tokens: int, dropless: bool = False) -> int:
    """Slots per expert for a call of `tokens` tokens: the reference's
    Python float arithmetic, or every replica where dropless."""
    m = cfg.moe
    if dropless:
        return tokens * m.top_k
    return int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1


def route(p, cfg, xt):
    """(gate values (T, K) f32, expert ids (T, K), aux loss) of tokens xt
    (T, d): the f32 router's softmax, its top-k in descending order (the
    order jax.lax.top_k gives, which decides the slot order), renormalized
    with a 1e-9 floor, and the Switch loss from the first choice."""
    m = cfg.moe
    logits = torch.matmul(xt.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    density = F.one_hot(expert_ids[:, 0], m.num_experts).float().mean(0)
    aux = m.num_experts * torch.sum(density * probs.mean(0))
    return gate_vals, expert_ids, aux


def moe_apply(p, cfg, x, compute_dtype=None, dropless: bool = False):
    """x: (B, N, d).  Returns (y (B, N, d), aux loss f32).

    dropless sizes capacity to every replica (tokens * top_k), so no token
    is dropped: the decode path's setting.  Prefill and training use the
    capacity factor."""
    m = cfg.moe
    b, n, d = x.shape
    tokens = b * n
    xt = x.reshape(tokens, d)
    if compute_dtype is not None:
        xt = xt.to(compute_dtype)
    gate_vals, expert_ids, aux = route(p, cfg, xt)
    cap = capacity(cfg, tokens, dropless)

    # slot of each (token, k) replica within its expert: an exclusive
    # cumsum over the flattened (token, k) order
    flat = F.one_hot(expert_ids.reshape(-1), m.num_experts)   # (T*K, E)
    slot = ((torch.cumsum(flat, dim=0) - flat) * flat).sum(-1)
    eid = expert_ids.reshape(-1)
    keep = slot < cap
    # dropped replicas go to the dump row (index E * cap)
    target = torch.where(keep, eid * cap + slot,
                         torch.full_like(slot, m.num_experts * cap))

    xr = xt.repeat_interleave(m.top_k, dim=0)                  # (T*K, d)
    buf = xt.new_zeros((m.num_experts * cap + 1, d)).index_put(
        (target,), xr)
    expert_in = buf[:-1].reshape(m.num_experts, cap, d)
    expert_out = _batched_swiglu(p["experts"], expert_in)
    out_flat = torch.cat([expert_out.reshape(-1, d),
                          expert_out.new_zeros((1, d))])
    gathered = out_flat[target]                                # (T*K, d)
    gates = torch.where(keep, gate_vals.reshape(-1),
                        torch.zeros_like(gate_vals.reshape(-1)))
    y = (gathered.reshape(tokens, m.top_k, d)
         * gates.reshape(tokens, m.top_k, 1).to(gathered.dtype)).sum(1)
    if "shared" in p:
        y = y + _shared_experts(p["shared"], xt)
    return y.reshape(b, n, d), aux


def _shared_experts(p_shared, xt):
    """The shared experts as plain per-token SwiGLUs, summed."""
    y = 0.0
    for s in range(p_shared["wi"].shape[0]):
        h = F.silu(xt @ p_shared["wg"][s].to(xt.dtype)) * (
            xt @ p_shared["wi"][s].to(xt.dtype))
        y = y + h @ p_shared["wo"][s].to(xt.dtype)
    return y
