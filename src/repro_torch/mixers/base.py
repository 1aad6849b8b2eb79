"""AttentionBackend protocol + registry — the single mixer dispatch point.

Port of `repro/mixers/base.py`.  Backend resolution from a ModelConfig:
  cfg.mixer == "attention"  -> cfg.attention_backend
  otherwise                 -> cfg.mixer
Resolution validates cfg.la: the kernel impl name must be registered in
the kernel family of the resolved backend (kernels/ops.py; `softmax` ->
"softmax", `gla` -> "gla", every other backend -> "linear") and the
chunk size positive; and cfg.paging: only the softmax (KV pages) and gla
(state pages) backends page their caches (page_size >= 1, num_pages >=
2); and the family: `encdec` needs a backend with encoder and
cross-attention-decode paths (the capability flags `supports_noncausal`
and `supports_cross_decode`, which `python -m repro_torch.check` holds
to the methods each backend overrides, REPRO-R002).  The port registers
the `linear`, `gla`, `softmax`, `mamba2` and `mla` backends, the
reference's five.
"""
from __future__ import annotations

from repro_torch.kernels import ops as _ops

_BACKENDS: dict[str, "AttentionBackend"] = {}


class AttentionBackend:
    """One token-mixing mechanism across training (apply), prefill and
    decode.

    Shapes (C = d_model): x: (B, N, C); positions: (B, N) absolute
    positions; decode takes x: (B, 1, C) and position: (B, 1) —
    PER-SLOT positions, slots of a continuously batched engine sit at
    different depths.
    """

    name: str = "?"
    # the mixer is the whole block (token and channel mixing, mamba2):
    # blocks add no FFN and no second norm around it
    fuses_ffn: bool = False
    # capability flags, checked at resolution so that a config needing
    # them fails there and not deep inside a step
    supports_noncausal: bool = False     # apply_noncausal (encoder, cross)
    supports_cross_decode: bool = False  # cross_precompute, cross_decode

    def init(self, gen, cfg, dtype):
        """-> params dict for one layer's mixer."""
        raise NotImplementedError

    def apply(self, p, cfg, x, positions, compute_dtype=None):
        """Causal self-attention over the full sequence (training)."""
        raise NotImplementedError

    def init_cache(self, cfg, batch: int, max_len: int, device, dtype):
        """-> per-layer decode cache; a KV cache is held in `dtype` (the
        compute dtype), a recurrent state in f32."""
        raise NotImplementedError

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        """Run a prompt window against `cache` -> (y, cache)."""
        raise NotImplementedError

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        """One token per slot -> (y, cache).  x: (B, 1, C)."""
        raise NotImplementedError

    # -- optional capabilities ------------------------------------------
    def apply_noncausal(self, p, cfg, x, ctx, positions=None,
                        compute_dtype=None):
        """Bidirectional attention: self (ctx = x) or cross (ctx = the
        encoder output)."""
        raise NotImplementedError(
            f"backend {self.name!r} has no non-causal (encoder/cross) path")

    def cross_precompute(self, p, cfg, ctx, compute_dtype=None):
        """A decode-time cross-attention state from `ctx`."""
        raise NotImplementedError(
            f"backend {self.name!r} has no cross-attention decode path")

    def cross_decode(self, p, cfg, x, state, compute_dtype=None):
        """One-token cross-attention readout against that state."""
        raise NotImplementedError(
            f"backend {self.name!r} has no cross-attention decode path")


def register_backend(name: str):
    """Class decorator: instantiate + register under `name`."""
    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls()
        return cls
    return deco


def registered_backends() -> list[str]:
    return sorted(_BACKENDS)


def resolve_backend_name(cfg) -> str:
    """ModelConfig -> registered backend name (no validation)."""
    return cfg.attention_backend if cfg.mixer == "attention" else cfg.mixer


def get_backend(cfg_or_name) -> AttentionBackend:
    """Resolve a ModelConfig (or a bare name) to its backend.

    Raises with the registered names on an unknown backend, and
    validates cfg.la at resolution time.
    """
    if isinstance(cfg_or_name, str):
        name, cfg = cfg_or_name, None
    else:
        name, cfg = resolve_backend_name(cfg_or_name), cfg_or_name
    backend = _BACKENDS.get(name)
    if backend is None:
        raise KeyError(
            f"unknown attention backend {name!r}; registered backends: "
            f"{registered_backends()} (cfg.mixer selects mla/mamba2, "
            f"cfg.attention_backend selects linear/gla/softmax)")
    if cfg is not None:
        la = cfg.la
        if la.chunk <= 0:
            raise ValueError(f"cfg.la.chunk must be positive, got {la.chunk}")
        if la.backend != "auto":
            # each mixer keys its kernel impl off cfg.la.backend, checked
            # against its own family (the reference's mapping)
            family = {"softmax": "softmax", "mamba2": "ssd",
                      "gla": "gla"}.get(name, "linear")
            _ops.get_kernel(family, la.backend)
        if cfg.paging is not None:
            if name not in ("softmax", "gla"):
                raise ValueError(
                    f"cfg.paging is a serving feature of the softmax "
                    f"(paged-KV rows) and gla (paged recurrent state) "
                    f"backends; backend {name!r} keeps its own "
                    f"non-paged decode cache — unset paging or switch "
                    f"backends")
            if cfg.paging.page_size < 1 or cfg.paging.num_pages < 2:
                raise ValueError(
                    f"cfg.paging needs page_size >= 1 and num_pages >= 2 "
                    f"(one page is the engine's reserved write sink), got "
                    f"page_size={cfg.paging.page_size} "
                    f"num_pages={cfg.paging.num_pages}")
        if cfg.family == "encdec" and not (backend.supports_noncausal
                                           and backend.supports_cross_decode):
            capable = [n for n, b in _BACKENDS.items()
                       if b.supports_noncausal and b.supports_cross_decode]
            raise ValueError(
                f"family 'encdec' needs a backend with encoder and "
                f"cross-attention-decode paths; {name!r} has none — "
                f"capable backends: {capable}")
    return backend
