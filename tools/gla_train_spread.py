"""The GLA train step's first-step comparison, applied to forwards and
backwards that differ only in rounding and to planted faults.

Full-width pythia-1.4b with the GLA mixer (seed-0 weights, the first
SyntheticLM batch of 2 x 8192 tokens, f32 params, remat), as
`chip_smoke.py`'s GLA train phase builds it.  Each variant swaps the
attention's forward, its backward or the scan chunk and goes through
`chip_smoke._train_legs`, the comparison `chip_smoke.py` holds the
kernel path to, in both of its legs against the plain path (forward and
backward chunked scans at the config's chunk of 512):

  bf16  the config's bf16 compute: the loss within 2^-8, and each kind
        of leaf (a weight over its 24 layers), in norm, within 2x the
        spread of a second plain run with half the chunk;
  f32   f32 compute: the loss within 1e-4, every grad within 2^-4 of
        its max |value|.

The variants:

  kernel          the kernel path itself (gla_fwd, gla_bwd_q, gla_bwd_kv)
  kernel_fwd      gla_fwd's kernel, the plain backward
  plain_fwd       the plain forward, the backward kernels
  walk_fwd        the token walk (gla_fwd on f32 copies of the inputs, o
                  rounded to the compute dtype), the backward kernels
  f64_fwd         the plain chunked scan in float64 (o rounded to the
                  compute dtype, g to f32), the backward kernels
  f64_fwd_plain   the same forward, the plain backward
  chunk_C         the plain path with a scan chunk of C (64, 128, 256,
                  1024)
  fault_dld_zero  the kernel path with dlog_decay zeroed after the
                  epilogue (planted fault)
  fault_dk_scaled the kernel path with dk scaled by 1 + 2^-3 (planted
                  fault)
  fault_ld_shift  the kernel path with gla_fwd fed the log decay shifted
                  one token later (token t decays by token t-1's gate;
                  planted fault)

An exact forward or backward must pass both legs; a planted fault should
fail at least one.  It prints one line per variant and leg (pass or fail,
the worst kind of leaf, grad or the loss, and its share of the limit),
then the table, and writes every number to --out.

    python tools/gla_train_spread.py [--out FILE] [--only NAME ...]

Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (64, 128, 256, 1024)


def log(msg):
    print(msg, flush=True)


def _gla_fwd_f64(q, k, v, ld, a, b, chunk):
    """The plain chunked scan (core/gla.py::gla_fwd_chunked) in float64."""
    import torch
    from repro_torch.core.numerics import safe_div
    bsz, h, n, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    grp, f64 = h // hkv, torch.float64
    qd, kd, ldd = q.to(f64), k.to(f64), ld.to(f64)
    va = torch.cat([v.to(f64), torch.ones(v.shape[:-1] + (1,), dtype=f64,
                                          device=v.device)], -1)
    s = torch.zeros(bsz, hkv, dk, dv + 1, dtype=f64, device=q.device)
    p = torch.zeros(bsz, hkv, dv + 1, dtype=f64, device=q.device)
    outs = []
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        qi = qd[:, :, c0:c1].reshape(bsz, hkv, grp, c1 - c0, dk)
        ki, vi = kd[:, :, c0:c1], va[:, :, c0:c1]
        cl = torch.cumsum(ldd[:, :, c0:c1], -1)
        tril = torch.ones(c1 - c0, c1 - c0, dtype=torch.bool,
                          device=q.device).tril()
        diff = torch.where(tril, cl[..., :, None] - cl[..., None, :], 0.0)
        dec = torch.where(tril, torch.exp(diff), 0.0)
        att = (a + b * torch.einsum("bhgid,bhjd->bhgij", qi, ki)) \
            * dec[:, :, None]
        f = torch.einsum("bhgij,bhje->bhgie", att, vi) \
            + torch.exp(cl)[:, :, None, :, None] * (
                a * p[:, :, None, None, :]
                + b * torch.einsum("bhgid,bhde->bhgie", qi, s))
        outs.append(f.reshape(bsz, h, c1 - c0, dv + 1))
        total = cl[..., -1:]
        vw = torch.exp(total - cl)[..., None] * vi
        s = torch.exp(total)[..., None] * s + torch.einsum(
            "bhjd,bhje->bhde", ki, vw)
        p = torch.exp(total) * p + vw.sum(-2)
    f = torch.cat(outs, 2)
    g = f[..., dv]
    return safe_div(f[..., :dv], g[..., None]).to(q.dtype), g.float()


def _variants(cs, dataclasses):
    """name -> function of a config (the leg's compute dtype) giving the
    config that runs the variant; each swapped impl registered in the
    `gla` family under the variant's name."""
    import torch
    from repro_torch.kernels import gla, ops

    kernel_fwd, kernel_bwd = ops._gla_cuda_fwd, ops._gla_cuda_bwd
    plain_fwd, plain_bwd = gla.gla_fwd_torch, gla.gla_bwd_torch

    def walk_fwd(q, k, v, ld, a, b, chunk):
        o, g = gla.gla_fwd_cuda(q.float().contiguous(),
                                k.float().contiguous(),
                                v.float().contiguous(),
                                ld.float().contiguous(), a, b)
        return o.to(q.dtype), g

    def dld_zero(*args):
        dq, dk, dv, dld = kernel_bwd(*args)
        return dq, dk, dv, torch.zeros_like(dld)

    def dk_scaled(*args):
        dq, dk, dv, dld = kernel_bwd(*args)
        return dq, (dk.float() * (1 + 2.0 ** -3)).to(dk.dtype), dv, dld

    def ld_shift(q, k, v, ld, a, b, chunk):
        later = torch.cat([torch.zeros_like(ld[..., :1]), ld[..., :-1]], -1)
        return kernel_fwd(q, k, v, later, a, b, chunk)

    swapped = {"kernel_fwd": (kernel_fwd, plain_bwd),
               "plain_fwd": (plain_fwd, kernel_bwd),
               "walk_fwd": (walk_fwd, kernel_bwd),
               "f64_fwd": (_gla_fwd_f64, kernel_bwd),
               "f64_fwd_plain": (_gla_fwd_f64, plain_bwd),
               "fault_dld_zero": (kernel_fwd, dld_zero),
               "fault_dk_scaled": (kernel_fwd, dk_scaled),
               "fault_ld_shift": (ld_shift, kernel_bwd)}

    def impl(name):
        return lambda c: cs._with_impl(c, name)

    def chunk(size):
        def make(c):
            c = cs._with_impl(c, "torch")
            return dataclasses.replace(c, la=dataclasses.replace(
                c.la, chunk=size))
        return make

    out = {"kernel": impl("cuda")}
    for name, (fwd, bwd) in swapped.items():
        ops.register_kernel("gla", name, fwd=fwd, bwd=bwd)
        out[name] = impl(name)
    out.update({f"chunk_{c}": chunk(c) for c in CHUNKS})
    return out


def spread(out_path, only):
    import dataclasses

    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as mdl

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card)
    cfg = cs._config("gla")
    params = mdl.init_params(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(data.batch_at(0)).to("cuda")}
    variants = _variants(cs, dataclasses)
    if only:
        variants = {k: v for k, v in variants.items() if k in only}
    legs = cs._train_legs(torch, mdl, cfg, params, batch, variants)
    rows = []
    for name, by_leg in legs.items():
        for leg, r in by_leg.items():
            verdict = "pass" if r["ok"] else "FAIL"
            rows.append(f"| {name} | {leg} | {verdict} | {r['worst']} | "
                        f"{r['ratio']:.4g} |")
            log(f"{name} {leg}: {verdict}, worst {r['worst']} at "
                f"{r['ratio']!r} of its limit (loss {r['loss']!r} vs "
                f"{r['loss_ref']!r})")
    log("| variant | leg | verdict | worst | share of its limit |")
    log("|---|---|---|---|---|")
    for row in rows:
        log(row)
    res = {"card": card, "legs": legs, "seconds": time.perf_counter() - t0}
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(res, indent=1))
    log(f"wrote {out_path} ({res['seconds']:.1f} s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "gla_train_spread.json"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="run these variants only")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 1
    spread(args.out, args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
