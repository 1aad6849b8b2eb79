"""Whether the SSD, linear-attention, GLA, recurrent decode and softmax
decode kernels of this tree give the same bits as those of another copy
of the port.

Builds `ssd_fwd`, `ssd_bwd_q`, `ssd_bwd_kv`, `la_fwd`, `la_bwd_q`,
`la_bwd_kv`, `gla_fwd`, `gla_bwd_q`, `gla_bwd_kv`, `la_decode_fused`,
`gla_decode_fused`, `softmax_decode_fused`, `paged_decode_fused` and
`paged_attention` from this tree's `src/` and from each DIR given, runs
each on the same inputs (made from a seed on the card): the SSD
kernels at mamba2-2.7b's training shape (B=2, G=1, H=80, N=8192, Dk=128,
Dv=64, a fresh layer's decays), at N=1000, G=4, H=16 under the strong
U[-5, 0] decays and at zamba2-7b's (64, 64) (B=2, G=1, H=112, N=8192, a
fresh layer's decays); the LA and GLA kernels at pythia-1.4b's (B=2,
H=Hkv=16, N=8192, D=128; the trained gate's decays), at N=1000, G=4 (the
strong decays) and at qwen2.5-3b's G = 8 (B=2, H=16, Hkv=2, N=8192, the
strong decays: `la_bwd_kv` and `gla_bwd_kv` split over 8 slices of the
group), in bf16 at D = 64 (the LA kernels' chunked bodies, the GLA
kernels' token walks), their token walks in f32 at D = 128, and the LA
kernels alone at D = 112 (bf16 with G = 4, f32); the
recurrent decode steps at the serving shape (B=8,
H=Hkv=16, D=128, the trained gate) and at G=4 (the strong decays), each
from the same f32 state; the softmax decode kernels at the serving shape
(B=8, H=Hkv=16, D=128, page size 16, 34 table entries per slot into a
shuffled arena, lengths in [1, 544] with a slot of length 0 and one past
the table; `softmax_decode_fused` on the same keys gathered into a
contiguous cache) and at G=4 with page size 5.  It prints for each
kernel and shape whether its outputs (o; the dq partials; the dk
partials and dv; o and g; dq; dk and dv or dV'; the recurrent decode
steps' new S and P apart from their o) equal this tree's bit for bit,
its largest difference, that difference over the other copy's largest
|value|, and whether that is within one bf16 step (2^-7).  Against a
copy from before the split of `la_bwd_kv` over the query group and
`ssd_fwd`'s chunked body at (64, 64), the `la_bwd_kv` and `gla_bwd_kv`
outputs of the G = 8 case (the slices' f32 partials added in order, then
rounded once) and the `ssd_fwd` o of the (64, 64) case (the chunked body
where the token walk ran) are within one bf16 step and not bit-equal;
every other case keeps its bits: `la_bwd_kv` and `gla_bwd_kv` at G = 1
and 4, `ssd_fwd` at (128, 64).

    python tools/bits_vs_parent.py DIR [DIR ...]

DIR is the `src/` of the other copy (e.g. unpacked by `git archive`).
Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the SSD kernels' cases: (B, G, H, N, decay regime, Dk); Dv = 64
CASES = {"main": (2, 1, 80, 8192, "init", 128),
         "n1000_g4": (2, 4, 16, 1000, "strong", 128),
         "zamba2_64": (2, 1, 112, 8192, "init", 64)}
# the LA and GLA kernels' cases: (B, H, Hkv, N, decay regime, D, dtype):
# the wgmma bodies (bf16 at D = 128; at G = 8 `la_bwd_kv` and
# `gla_bwd_kv` split over the group), the token walks in f32, bf16 at
# D = 64 (the LA kernels' wgmma bodies, the GLA kernels' walks), and the
# walks at D = 112 (no regime: the LA kernels alone, the gated entries do
# not take 112)
LA_CASES = {"la_main": (2, 16, 16, 8192, "trained", 128, "bfloat16"),
            "la_n1000_g4": (2, 16, 4, 1000, "strong", 128, "bfloat16"),
            "la_g8_split": (2, 16, 2, 8192, "strong", 128, "bfloat16"),
            "walk_f32": (2, 16, 16, 1000, "trained", 128, "float32"),
            "d64_bf16": (2, 16, 16, 1000, "strong", 64, "bfloat16"),
            "walk_d112_g4_bf16": (2, 16, 4, 1000, None, 112, "bfloat16"),
            "walk_d112_f32": (2, 16, 16, 300, None, 112, "float32")}
# the decode steps' cases: (B, H, Hkv, decay regime)
DECODE_CASES = {"decode_main": (8, 16, 16, "trained"),
                "decode_g4": (8, 16, 4, "strong")}
# the softmax decode kernels' cases: (B, H, Hkv, page size, Pmax)
PAGED_CASES = {"paged_main": (8, 16, 16, 16, 34),
               "paged_g4_ps5": (8, 16, 4, 5, 109)}
BF16_STEP = 2.0 ** -7


def dump(path):
    """Every compared kernel's outputs on the fixed inputs, saved to
    `path`."""
    import torch
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels import ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    out = {}
    for name, (b, g, h, n, regime, dk_) in CASES.items():
        def bf16(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device="cuda")).bfloat16()
        q, k = bf16(b, g, n, dk_, scale=0.5), bf16(b, g, n, dk_, scale=0.5)
        v, om = bf16(b, h, n, 64), bf16(b, h, n, 64)
        x = torch.randn((b, h, n), generator=gen, device="cuda")
        ld = (-torch.nn.functional.softplus(x) if regime == "init"
              else -5.0 * torch.rand((b, h, n), generator=gen,
                                     device="cuda"))
        dk, dv = ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        out[name] = {"ssd_fwd": [ssd.ssd_fwd_cuda(q, k, v, ld).cpu()],
                     "ssd_bwd_q": [ssd.ssd_bwd_q_cuda(k, v, ld, om).cpu()],
                     "ssd_bwd_kv": [dk.cpu(), dv.cpu()]}
    def unit(*shape, dtype=torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    def log_decay(shape, regime):
        """The trained gate's log_sigmoid(N(0, 1) + 6), or U[-5, 0]."""
        if regime == "trained":
            return torch.nn.functional.logsigmoid(
                torch.randn(shape, generator=gen, device="cuda") + 6.0)
        return -5.0 * torch.rand(shape, generator=gen, device="cuda")

    for name, (b, h, hkv, n, regime, d, dt) in LA_CASES.items():
        dt = getattr(torch, dt)
        q, k = unit(b, h, n, d, dtype=dt), unit(b, hkv, n, d, dtype=dt)
        v = torch.randn((b, hkv, n, d), generator=gen,
                        device="cuda").to(dt)
        om_hat = torch.randn((b, h, n, d), generator=gen, device="cuda")
        h_vec = torch.randn((b, h, n), generator=gen, device="cuda")
        o, g_ = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
        dk, dv = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
        out[name] = {"la_fwd": [o.cpu(), g_.cpu()],
                     "la_bwd_q": [la.la_bwd_q_cuda(k, v, om_hat, h_vec,
                                                   1.0).cpu()],
                     "la_bwd_kv": [dk.cpu(), dv.cpu()]}
        if regime is None:
            continue
        ld = log_decay((b, hkv, n), regime)
        go, gg = gla.gla_fwd_cuda(q, k, v, ld, 1.0, 1.0)
        gdk, gdva = gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0, 1.0)
        out[name].update({
            "gla_fwd": [go.cpu(), gg.cpu()],
            "gla_bwd_q": [gla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec,
                                             1.0).cpu()],
            "gla_bwd_kv": [gdk.cpu(), gdva.cpu()]})
    for name, (b, h, hkv, regime) in DECODE_CASES.items():
        s = torch.randn((b, hkv, 128, 129), generator=gen, device="cuda")
        p = torch.randn((b, hkv, 129), generator=gen,
                        device="cuda").abs() + 1.0
        q, k = unit(b, h, 128), unit(b, hkv, 128)
        v = torch.randn((b, hkv, 128), generator=gen,
                        device="cuda").bfloat16()
        ld = log_decay((b, hkv), regime)
        s_l, p_l, s_g, p_g = s.clone(), p.clone(), s.clone(), p.clone()
        o_l = df.la_decode_fused_cuda(s_l, p_l, q, k, v, 1.0, 1.0)
        o_g = df.gla_decode_fused_cuda(s_g, p_g, q, k, v, ld, 1.0, 1.0)
        out[name] = {"la_decode_fused_state": [s_l.cpu(), p_l.cpu()],
                     "la_decode_fused_o": [o_l.cpu()],
                     "gla_decode_fused_state": [s_g.cpu(), p_g.cpu()],
                     "gla_decode_fused_o": [o_g.cpu()]}
    from repro_torch.kernels import paged_attention as pg
    for name, (b, h, hkv, ps, pmax) in PAGED_CASES.items():
        num_pages = b * pmax + 1
        q = torch.randn((b, h, 1, 128), generator=gen,
                        device="cuda").bfloat16()
        kp, vp = (torch.randn((num_pages, hkv, ps, 128), generator=gen,
                              device="cuda").bfloat16() for _ in range(2))
        table = torch.randperm(num_pages - 1, generator=gen,
                               device="cuda").to(torch.int32).reshape(
                                   b, pmax)
        lengths = torch.randint(1, pmax * ps + 1, (b,), generator=gen,
                                device="cuda").to(torch.int32)
        lengths[0], lengths[1] = 0, pmax * ps + 3
        contiguous = (q, pg.gather_pages(kp, table),
                      pg.gather_pages(vp, table), lengths)
        out[name] = {
            "paged_decode_fused": [df.paged_decode_fused_cuda(
                q, kp, vp, table, lengths).cpu()],
            "paged_attention": [pg.paged_attention_cuda(
                q, kp, vp, table, lengths).cpu()],
            "softmax_decode_fused": [df.softmax_decode_fused_cuda(
                *contiguous).cpu()]}
    torch.save(out, path)


def compare(mine, other):
    """Bit equality of two lists of outputs, their largest difference,
    that over the other's largest |value|, and whether it is within one
    bf16 step."""
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(mine, other))
    rel = diff / max(max(float(b.float().abs().max()) for b in other),
                     1e-30)
    return {"bit_equal": all(a.equal(b) for a, b in zip(mine, other)),
            "max_abs_diff": diff, "max_rel_diff": rel,
            "within_one_bf16_step": rel <= BF16_STEP}


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--dump":
        sys.path.insert(0, sys.argv[3])
        dump(sys.argv[2])
        return 0
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        def run(src, label):
            path = os.path.join(tmp, f"{label}.pt")
            subprocess.run([sys.executable, __file__, "--dump", path,
                            str(src)], check=True,
                           env=dict(os.environ, PYTHONPATH=str(src)))
            return torch.load(path)

        mine = run(ROOT / "src", "tree")
        for i, other_src in enumerate(sys.argv[1:]):
            other = run(other_src, f"other{i}")
            res[other_src] = {
                case: {kern: compare(ts, other[case][kern])
                       for kern, ts in kernels.items()}
                for case, kernels in mine.items()}
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
