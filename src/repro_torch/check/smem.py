"""Shared-memory legality of the default sizes (the port's counterpart of
`repro/check/vmem.py`).

  REPRO-V001  at every (architecture x shape) cell of the port's registry
              (`configs/registry.py`) against the workload shapes `SHAPES`,
              every kernel entry that architecture runs, with the sizes of
              `kernels/defaults.py`, fits its launcher's shared-memory
              limit in both compute dtypes: the untuned launch must not be
              refused on any registered workload.  The check evaluates the
              same launch plans the bounds pass proves (kernels/*.py), on
              meta tensors, so the analyzer and the launcher cannot
              disagree; where a launcher shrinks its staging to fit
              (`la_bwd_kv` for large query groups) the coverage record
              gives the stage it keeps.  An architecture runs the
              kernels of every backend whose kernels take its shapes:
              the hybrid's shared block the linear ones (the launchers
              refuse gla and softmax for its head dim 112), the MLA mixer
              (deepseek-v2-236b) only the linear ones at its (Dk, Dv) =
              (192, 128), and the softmax decode kernels only at their
              query groups (not qwen2-vl-7b's 7 nor granite-20b's 48);
              the coverage record lists what is left out.
  REPRO-V002  reserved: the port has no tuning cache yet (ROADMAP queue 1
              item 10); the coverage record says so.
"""
from __future__ import annotations

import torch

from repro_torch.check.findings import Finding
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import _MODULES, get_config
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import gla
from repro_torch.kernels import linear_attention as la
from repro_torch.kernels import paged_attention as pg
from repro_torch.kernels import ssd

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
DTYPES = (F32, BF16)
PAGE_SIZE = 16   # PagingCfg's default page size


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def registry_cells() -> list[tuple[str, str, dict]]:
    """Every (arch, shape name, dims) cell: decode shapes run the training
    kernels at N = 1, as the reference's vmem pass does, and the decode
    kernels over a cache of the shape's length."""
    cells = []
    for arch in _MODULES:
        cfg = get_config(arch)
        # head dims (Dk, Dv): MLA decompresses q and k to nope + rope, v to
        # its own width
        dk = dv = cfg.resolved_head_dim
        if cfg.mixer == "mla":
            dk = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
            dv = cfg.mla.v_head_dim
        for name, sc in SHAPES.items():
            dims = {"b": sc.global_batch, "h": cfg.num_heads,
                    "hkv": cfg.num_kv_heads, "d": dk, "dv": dv,
                    "n": 1 if sc.kind == "decode" else sc.seq_len,
                    "cache": sc.seq_len, "family": cfg.family,
                    "mixer": cfg.mixer}
            if cfg.ssm is not None:
                dims["ssm"] = dict(
                    dk=cfg.ssm.state_dim, dv=cfg.ssm.head_dim,
                    h=cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim, g=1)
            cells.append((arch, name, dims))
    return cells


def left_out(dims: dict) -> list[str]:
    """The entries a cell's architecture does not run on the card: the
    backends whose kernels do not take its shapes."""
    family = dims["family"]
    if family == "ssm":
        return []
    out = []
    if dims["mixer"] == "mla":
        return ["gla_fwd", "gla_bwd_q", "gla_bwd_kv", "gla_decode_fused",
                "flash_fwd", "flash_bwd_delta", "flash_bwd_q",
                "flash_bwd_kv", "softmax_decode_fused", "paged_attention",
                "paged_decode_fused"]
    if family == "hybrid":
        out += ["gla_fwd", "gla_bwd_q", "gla_bwd_kv", "gla_decode_fused",
                "flash_fwd", "flash_bwd_delta", "flash_bwd_q",
                "flash_bwd_kv"]
    if family == "hybrid" or dims["h"] // dims["hkv"] not in df.GROUPS:
        out += ["softmax_decode_fused", "paged_attention",
                "paged_decode_fused"]
    return out


def cell_plans(dims: dict, dtype) -> list:
    """The launch plans of every entry the cell's architecture runs."""
    b, n = dims["b"], dims["n"]
    plans = []
    if "ssm" in dims:
        m = dims["ssm"]
        q = _meta(b, m["g"], n, m["dk"], dtype=dtype)
        v = _meta(b, m["h"], n, m["dv"], dtype=dtype)
        ld = _meta(b, m["h"], n)
        plans += [ssd.plan_ssd_fwd(q, q, v, ld),
                  ssd.plan_ssd_bwd_q(q, v, ld, v),
                  ssd.plan_ssd_bwd_kv(q, q, v, ld, v)]
    if dims["family"] == "ssm":
        return plans
    h, hkv, d, s_len = dims["h"], dims["hkv"], dims["d"], dims["cache"]
    dv = dims["dv"]
    q = _meta(b, h, n, d, dtype=dtype)
    kv = _meta(b, hkv, n, d, dtype=dtype)
    v = _meta(b, hkv, n, dv, dtype=dtype)
    ld, h_vec, om = _meta(b, hkv, n), _meta(b, h, n), _meta(b, h, n, dv)
    pmax = -(-s_len // PAGE_SIZE)
    q1 = _meta(b, h, 1, d, dtype=dtype)
    cache = _meta(b, hkv, s_len, d, dtype=dtype)
    pages = _meta(b * pmax + 1, hkv, PAGE_SIZE, d, dtype=dtype)
    table, lengths = _meta(b, pmax, dtype=I32), _meta(b, dtype=I32)
    state = (_meta(b, hkv, d, dv + 1), _meta(b, hkv, dv + 1))
    step = (_meta(b, h, d, dtype=dtype), _meta(b, hkv, d, dtype=dtype),
            _meta(b, hkv, dv, dtype=dtype))
    every = {
        "la_fwd": lambda: la.plan_la_fwd(q, kv, v, 1.0, 1.0),
        "la_bwd_q": lambda: la.plan_la_bwd_q(kv, v, om, h_vec, 1.0),
        "la_bwd_kv": lambda: la.plan_la_bwd_kv(q, kv, v, om, h_vec, 1.0,
                                               1.0),
        "gla_fwd": lambda: gla.plan_gla_fwd(q, kv, kv, ld, 1.0, 1.0),
        "gla_bwd_q": lambda: gla.plan_gla_bwd_q(kv, kv, ld, om, h_vec, 1.0),
        "gla_bwd_kv": lambda: gla.plan_gla_bwd_kv(q, kv, kv, ld, om, h_vec,
                                                  1.0, 1.0),
        "flash_fwd": lambda: fl.plan_flash_fwd(q, kv, kv),
        "flash_bwd_delta": lambda: fl.plan_flash_bwd_delta(q, q),
        "flash_bwd_q": lambda: fl.plan_flash_bwd_q(q, kv, kv, q, h_vec,
                                                   h_vec),
        "flash_bwd_kv": lambda: fl.plan_flash_bwd_kv(q, kv, kv, q, h_vec,
                                                     h_vec),
        "la_decode_fused": lambda: df.plan_la_decode_fused(*state, *step,
                                                           1.0, 1.0),
        "gla_decode_fused": lambda: df.plan_gla_decode_fused(
            *state, *step, _meta(b, hkv), 1.0, 1.0),
        "softmax_decode_fused": lambda: df.plan_softmax_decode_fused(
            q1, cache, cache, lengths),
        "paged_attention": lambda: pg.plan_paged_attention(
            q1, pages, pages, table, lengths),
        "paged_decode_fused": lambda: df.plan_paged_decode_fused(
            q1, pages, pages, table, lengths)}
    skip = left_out(dims)
    return plans + [make() for name, make in every.items()
                    if name not in skip]


def check_defaults(cells=None) -> tuple[list[Finding], dict]:
    """REPRO-V001 over the (entry x arch x shape x dtype) product; also the
    least stage each staging entry keeps."""
    findings, stages = [], {}
    for arch, shape_name, dims in registry_cells() if cells is None \
            else cells:
        for dtype in DTYPES:
            for launch in cell_plans(dims, dtype):
                if launch.stage is not None:
                    stages[launch.name] = min(stages.get(launch.name,
                                                         launch.stage),
                                              launch.stage)
                if launch.smem > launch.smem_limit:
                    findings.append(Finding(
                        "REPRO-V001",
                        f"kernels/defaults.py[{launch.name}] @ "
                        f"{arch}/{shape_name}/{str(dtype)[6:]}",
                        f"needs {launch.smem} B of shared memory (> the "
                        f"launcher's limit {launch.smem_limit} B)"))
    return findings, stages


def run(log=lambda s: None) -> tuple[list[Finding], list[dict]]:
    cells = registry_cells()
    findings, stages = check_defaults(cells)
    log(f"check,smem,defaults,{'FAIL' if findings else 'ok'} "
        f"({len(cells)} cells x {len(DTYPES)} dtypes)")
    coverage = [{"pass": "smem", "cells": len(cells),
                 "archs": sorted(_MODULES), "shapes": sorted(SHAPES),
                 "least_stage": stages,
                 "left_out": {arch: left_out(dims)
                              for arch, _, dims in cells if left_out(dims)},
                 "not_audited": {"REPRO-V002": "the port has no tuning "
                                               "cache yet"}}]
    return findings, coverage
