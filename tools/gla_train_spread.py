"""How far the GLA train step's first-step grads move when only the
attention forward's rounding changes.

Full-width pythia-1.4b with the GLA mixer (seed-0 weights, the first
SyntheticLM batch of 2 x 8192 tokens, f32 params, bf16 compute, remat),
as `chip_smoke.py`'s GLA train phase builds it.  The reference is the
plain path (forward and backward chunked scans at the config's chunk of
512).  Each variant swaps the attention forward, or the chunk, and runs
the same loss and grads; for each compared grad (every layer's
wq/wk/wv/wo, ln_f and lm_head) it reports max |grad - reference| over
the reference's max |value|, the measure `chip_smoke.py` holds to
2^-4.  The variants:

  kernel            gla_fwd's kernel and the backward kernels (the
                    kernel path itself)
  kernel_fwd        gla_fwd's kernel, the plain backward
  plain_fwd         the plain forward, the backward kernels
  walk_fwd          the token walk (gla_fwd on f32 copies of the bf16
                    inputs, o rounded to bf16), the backward kernels
  f64_fwd           the plain chunked scan in float64 (o rounded to
                    bf16, g to f32), the backward kernels
  f64_fwd_plain     the same forward, the plain backward
  kernel_o_plain_g  o from the kernel, g from the plain forward
  plain_o_kernel_g  o from the plain forward, g from the kernel
  chunk_C           the plain path with a scan chunk of C (64, 128,
                    256, 1024)

It also takes layer 14's attention inputs from the reference run and
reports, for each forward against the plain one there, the share of bf16
o values that differ (and how many of those are larger) and g's mean and
largest relative difference.

    python tools/gla_train_spread.py [--out FILE]

Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = (64, 128, 256, 1024)
CAPTURE_LAYER = 14


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


def _o_g_stats(torch, o, g, o_ref, g_ref):
    """Share of bf16 o values that differ from the reference's, the
    share of those that are larger, and g's relative differences."""
    diff = o.float() - o_ref.float()
    ne = diff != 0
    n_ne = int(ne.sum())
    rel_g = (g.double() - g_ref.double()) / g_ref.double().abs().clamp_min(
        1e-30)
    return {"o_differ_share": n_ne / o.numel(),
            "o_larger_share_of_differing": (int((diff > 0).sum()) / n_ne
                                            if n_ne else None),
            "g_rel_mean": float(rel_g.mean()),
            "g_rel_max_abs": float(rel_g.abs().max())}


def spread(out_path):
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import gla, ops
    from repro_torch.models import model as mdl
    from repro_torch.tree import named_leaves

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(card)
    res = {"card": card}

    cfg = cs._config("gla")
    params = mdl.init_params(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(data.batch_at(0)).to("cuda")}
    named = [(p, t) for p, t in named_leaves(params) if cs._compared_grad(p)
             and ".wg." not in p]
    for _, t in named:
        t.requires_grad_(True)

    def kernel_fwd(q, k, v, ld, a, b, chunk):
        return ops._gla_cuda_fwd(q, k, v, ld, a, b, chunk)

    def plain_fwd(q, k, v, ld, a, b, chunk):
        return gla.gla_fwd_torch(q, k, v, ld, a, b, chunk)

    def walk_fwd(q, k, v, ld, a, b, chunk):
        o, g = gla.gla_fwd_cuda(q.float().contiguous(),
                                k.float().contiguous(),
                                v.float().contiguous(),
                                ld.float().contiguous(), a, b)
        return o.to(q.dtype), g

    def mixed(o_fwd, g_fwd):
        def fwd(*args):
            return o_fwd(*args)[0], g_fwd(*args)[1]
        return fwd

    fwds = {"kernel": kernel_fwd, "plain": plain_fwd, "walk": walk_fwd,
            "f64": _gla_fwd_f64}
    kernel_bwd, plain_bwd = ops._gla_cuda_bwd, gla.gla_bwd_torch
    variants = {
        "kernel": (kernel_fwd, kernel_bwd, None),
        "kernel_fwd": (kernel_fwd, plain_bwd, None),
        "plain_fwd": (plain_fwd, kernel_bwd, None),
        "walk_fwd": (walk_fwd, kernel_bwd, None),
        "f64_fwd": (_gla_fwd_f64, kernel_bwd, None),
        "f64_fwd_plain": (_gla_fwd_f64, plain_bwd, None),
        "kernel_o_plain_g": (mixed(kernel_fwd, plain_fwd), kernel_bwd, None),
        "plain_o_kernel_g": (mixed(plain_fwd, kernel_fwd), kernel_bwd, None),
        **{f"chunk_{c}": (plain_fwd, plain_bwd, c) for c in CHUNKS}}

    captured = {}

    def capture(q, k, v, ld, a, b, chunk):
        if captured.setdefault("calls", 0) == CAPTURE_LAYER:
            captured["args"] = tuple(t.detach().clone() for t in (q, k, v, ld)
                                     ) + (a, b, chunk)
        captured["calls"] += 1
        return plain_fwd(q, k, v, ld, a, b, chunk)

    def run(fwd, bwd, chunk):
        ops.register_kernel("gla", "spread", fwd=fwd, bwd=bwd)
        c = cs._with_impl(cfg, "spread")
        if chunk:
            c = dataclasses.replace(c, la=dataclasses.replace(c.la,
                                                              chunk=chunk))
        loss, _ = mdl.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        return float(loss.detach()), grads

    loss_ref, ref = run(capture, plain_bwd, None)
    log(f"reference (plain path, chunk {cfg.la.chunk}): loss {loss_ref!r}")
    res["reference_loss"] = loss_ref
    res["variants"] = {}
    for name, (fwd, bwd, chunk) in variants.items():
        loss, grads = run(fwd, bwd, chunk)
        rel = {}
        for (path, _), gv, gr in zip(named, grads, ref):
            err, scale = cs.rel_err(gv, gr)
            rel[path] = err / scale
        del grads
        worst = max(rel, key=rel.get)
        over = sorted(p for p, r in rel.items() if r > cs.TRAIN_GRAD_REL)
        res["variants"][name] = {"loss": loss, "max": rel[worst],
                                 "worst": worst, "over_limit": over,
                                 "rel": rel}
        log(f"{name}: loss {loss!r}, worst {worst} at {rel[worst]!r}, "
            f"over {cs.TRAIN_GRAD_REL}: {over}")

    q, k, v, ld, a, b, chunk = captured["args"]
    o_ref, g_ref = plain_fwd(q, k, v, ld, a, b, chunk)
    res["layer"] = {"index": CAPTURE_LAYER, "shape": list(q.shape)}
    for name, fwd in fwds.items():
        if name == "plain":
            continue
        o, g = fwd(q, k, v, ld, a, b, chunk)
        res["layer"][name] = _o_g_stats(torch, o, g, o_ref, g_ref)
    for c in CHUNKS:
        o, g = plain_fwd(q, k, v, ld, a, b, c)
        res["layer"][f"chunk_{c}"] = _o_g_stats(torch, o, g, o_ref, g_ref)
    log(f"layer {CAPTURE_LAYER} against the plain forward: "
        f"{ {k_: v_ for k_, v_ in res['layer'].items()} }")
    res["seconds"] = time.perf_counter() - t0
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(res, indent=1))
    log(f"wrote {out_path} ({res['seconds']:.1f} s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "gla_train_spread.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 1
    spread(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
