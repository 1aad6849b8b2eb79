"""Whether the SSD and linear-attention kernels of this tree give the
same bits as those of another copy of the port.

Builds `ssd_fwd`, `ssd_bwd_q`, `ssd_bwd_kv`, `la_fwd`, `la_bwd_q` and
`la_bwd_kv` from this tree's `src/` and from each DIR given, runs each on
the same bf16 inputs (made from a seed on the card): the SSD kernels at
mamba2-2.7b's training shape (B=2, G=1, H=80, N=8192, Dk=128, Dv=64, a
fresh layer's decays) and at N=1000, G=4, H=16 under the strong U[-5, 0]
decays; the LA kernels at pythia-1.4b's (B=2, H=Hkv=16, N=8192, D=128)
and at N=1000, G=4.  It prints for each kernel and shape whether its
outputs (o; the dq partials; the dk partials and dv; o and g; dq; dk and
dv) equal this tree's bit for bit, and its largest difference if not.

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
CASES = {"main": (2, 1, 80, 8192, "init"), "n1000_g4": (2, 4, 16, 1000,
                                                       "strong")}
# the LA kernels' cases: (B, H, Hkv, N)
LA_CASES = {"la_main": (2, 16, 16, 8192), "la_n1000_g4": (2, 16, 4, 1000)}


def dump(path):
    """Every compared kernel's outputs on the fixed inputs, saved to
    `path`."""
    import torch
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels import ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    out = {}
    for name, (b, g, h, n, regime) in CASES.items():
        def bf16(*shape, scale=1.0):
            return (scale * torch.randn(shape, generator=gen,
                                        device="cuda")).bfloat16()
        q, k = bf16(b, g, n, 128, scale=0.5), bf16(b, g, n, 128, scale=0.5)
        v, om = bf16(b, h, n, 64), bf16(b, h, n, 64)
        x = torch.randn((b, h, n), generator=gen, device="cuda")
        ld = (-torch.nn.functional.softplus(x) if regime == "init"
              else -5.0 * torch.rand((b, h, n), generator=gen,
                                     device="cuda"))
        dk, dv = ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        out[name] = {"ssd_fwd": [ssd.ssd_fwd_cuda(q, k, v, ld).cpu()],
                     "ssd_bwd_q": [ssd.ssd_bwd_q_cuda(k, v, ld, om).cpu()],
                     "ssd_bwd_kv": [dk.cpu(), dv.cpu()]}
    for name, (b, h, hkv, n) in LA_CASES.items():
        def unit(*shape):
            x = torch.randn(shape, generator=gen, device="cuda")
            return (x / x.norm(dim=-1, keepdim=True)).bfloat16()
        q, k = unit(b, h, n, 128), unit(b, hkv, n, 128)
        v = torch.randn((b, hkv, n, 128), generator=gen,
                        device="cuda").bfloat16()
        om_hat = torch.randn((b, h, n, 128), generator=gen, device="cuda")
        h_vec = torch.randn((b, h, n), generator=gen, device="cuda")
        o, g_ = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
        dk, dv = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
        out[name] = {"la_fwd": [o.cpu(), g_.cpu()],
                     "la_bwd_q": [la.la_bwd_q_cuda(k, v, om_hat, h_vec,
                                                   1.0).cpu()],
                     "la_bwd_kv": [dk.cpu(), dv.cpu()]}
    torch.save(out, path)


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
                case: {kern: {"bit_equal": all(torch.equal(a, b) for a, b
                                               in zip(ts, other[case][kern])),
                              "max_abs_diff": max(
                                  float((a.float() - b.float()).abs().max())
                                  for a, b in zip(ts, other[case][kern]))}
                       for kern, ts in kernels.items()}
                for case, kernels in mine.items()}
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
