"""Decay-gated linear attention backend (GLA-style).

Port of `repro/mixers/gla.py`: the paper's normalized f(x) = a + b x
linear attention (the `linear` backend) with a LEARNED per-KV-head,
per-token decay gate multiplying the running state (Yang et al., "Gated
Linear Attention Transformers with Hardware-Efficient Training").
Training goes through `ops.gla_causal` (the autograd Function with the
analytic backward; gradients reach the gate through dlog_decay), prefill
through the plain chunked scan with state in and out, and decode through
the fused gated step family (kernels/decode_fused.py).

The gate is one dense head per layer: log_decay = log_sigmoid(x @ wg +
DECAY_BIAS) in f32, one scalar per token per KV head (the decayed state
is per KV head and shared by its query group).  DECAY_BIAS starts the
gate near gamma = 1, where the backend is the linear family.

Two cache layouts: a GLAState per layer (contiguous, batch-major), or
with cfg.paging a PagedGLAState, each slot's whole O(D^2) state one page
of an arena shared by the slots.  As in the reference, the paged layout
gathers the slots' pages into a batch state around the step and
scatters it back; the scatter writes the arenas IN PLACE, so a paged
prefill carry that holds the engine's arenas updates them directly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import l2_normalize
from repro_torch.kernels import ops as _ops
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import GLAState, PagedGLAState, init_gla_state
from repro_torch.mixers.qkv import GQAProjectionBackend
from repro_torch.models.common import dense, dense_init

F32 = torch.float32

# log_sigmoid(6) ~ -0.0025: the init decay gamma ~ 0.9975 per token, so a
# fresh layer behaves like the undecayed linear family and learns to
# forget rather than having to learn to remember
DECAY_BIAS = 6.0


@register_backend("gla")
class GLAAttentionBackend(GQAProjectionBackend):
    def init(self, gen, cfg, dtype=F32):
        p = super().init(gen, cfg, dtype)
        p["wg"] = dense_init(gen, cfg.d_model, cfg.num_kv_heads, bias=True,
                             dtype=dtype)
        return p

    def _log_decay(self, p, cfg, x, compute_dtype):
        """x: (B, N, C) -> per-KV-head log decay (B, Hkv, N) <= 0, f32."""
        logits = dense(p["wg"], x, compute_dtype)           # (B, N, Hkv)
        return F.logsigmoid(logits.float() + DECAY_BIAS).transpose(1, 2)

    def _qkv_ld(self, p, cfg, x, positions, compute_dtype):
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        if cfg.la.normalize_qk:
            # paper Eq. 22: with a, b > 0 this keeps the decayed
            # normalizer strictly positive, as in the linear family
            q, k = l2_normalize(q), l2_normalize(k)
        return q, k, v, self._log_decay(p, cfg, x, compute_dtype)

    def apply(self, p, cfg, x, positions, compute_dtype=None):
        q, k, v, ld = self._qkv_ld(p, cfg, x, positions, compute_dtype)
        la = cfg.la
        o = _ops.gla_causal(q, k, v, ld, la.a, la.b, la.chunk, la.backend)
        return self.out(p, o, compute_dtype)

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=None):
        # O(D^2) f32 state, independent of max_len and the compute dtype
        hd = cfg.resolved_head_dim
        if cfg.paging is not None:
            pg = cfg.paging
            # one state page per slot; unassigned rows -> the engine's
            # sink page (the arena's last).  page_size is a KV-row notion
            # and is ignored: a page IS one (Hkv, Dk, Dv+1) state.
            return PagedGLAState(
                s_pages=torch.zeros((pg.num_pages, cfg.num_kv_heads, hd,
                                     hd + 1), dtype=F32, device=device),
                p_pages=torch.zeros((pg.num_pages, cfg.num_kv_heads,
                                     hd + 1), dtype=F32, device=device),
                page_table=torch.full((batch, 1), pg.num_pages - 1,
                                      dtype=torch.int32, device=device))
        return init_gla_state(batch, cfg.num_kv_heads, hd, hd, device=device)

    @staticmethod
    def _gather_state(cache: PagedGLAState) -> GLAState:
        page = cache.page_table[:, 0].long()
        return GLAState(s=cache.s_pages[page], p=cache.p_pages[page])

    @staticmethod
    def _scatter_state(cache: PagedGLAState, st: GLAState) -> PagedGLAState:
        # live slots own distinct pages (engine invariant); retired slots
        # share the sink page, where any one of their duplicate writes may
        # land: nothing reads the sink into a live output
        page = cache.page_table[:, 0].long()
        cache.s_pages[page] = st.s.float()
        cache.p_pages[page] = st.p.float()
        return cache

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        q, k, v, ld = self._qkv_ld(p, cfg, x, positions, compute_dtype)
        la = cfg.la
        paged = isinstance(cache, PagedGLAState)
        st = self._gather_state(cache) if paged else cache
        o, st = _ops.gla_prefill(q, k, v, ld, la.a, la.b, la.chunk, state=st)
        cache = self._scatter_state(cache, st) if paged else st
        return self.out(p, o, compute_dtype), cache

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        q, k, v, ld = self._qkv_ld(p, cfg, x, position, compute_dtype)
        la = cfg.la
        paged = isinstance(cache, PagedGLAState)
        st = self._gather_state(cache) if paged else cache
        if la.fused_decode:
            st, o = _ops.gla_decode_step_fused(
                st, q[:, :, 0], k[:, :, 0], v[:, :, 0], ld[:, :, 0], la.a,
                la.b, backend=la.backend)
        else:
            st, o = _ops.gla_decode_step(st, q[:, :, 0], k[:, :, 0],
                                         v[:, :, 0], ld[:, :, 0], la.a, la.b)
        cache = self._scatter_state(cache, st) if paged else st
        return self.out(p, o[:, :, None], compute_dtype), cache
