"""The decode kernels' own times, by CUDA graph replay, of this tree and of
other copies of the port, on one card in turns.

For each `src/` (this tree's and each DIR given) it builds the decode
kernels from that copy and times the pairs of `chip_smoke.py`'s timing
phases on their inputs (`chip_smoke.recurrent_graph_times` and
`paged_graph_times`), each captured 200 launches to a CUDA graph and the
graphs replayed in turns:

  * `la_decode_fused` in turns with `gla_decode_fused` (B=8, H=Hkv=16,
    D=128, bf16; 8 rotating f32 states, cold in L2);
  * `paged_decode_fused` in turns with `paged_attention` on the same
    inputs (every slot at 544 live keys, page size 16, 34 table entries
    into a shuffled arena; 8 rotating arenas, cold in L2);
  * `paged_decode_fused` in turns with `softmax_decode_fused` on the same
    keys gathered into a contiguous cache.

The copies run in the order DIRs, this tree, this tree, DIRs (each in its
own process), and the card's name and power limit are printed beside the
JSON of every run's ms per launch.

    python tools/decode_times.py DIR [DIR ...]
    python tools/decode_times.py --tiles

`--tiles` times this tree's `softmax_decode_fused` on the contiguous
caches of the paged pairs' keys at tiles of 16, 32 and 64 rows (the C
entry's tile_rows), each in turns with DECODE_TILE_ROWS, and gives each
one's error against the plain version and whether it has
DECODE_TILE_ROWS's bits.

DIR is the `src/` of another copy (e.g. the parent unpacked by `git
archive`).  Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure():
    """Every pair's ms per launch, from the `repro_torch` first on the
    path: `chip_smoke`'s own pairs on its own inputs."""
    import torch

    import chip_smoke as cs
    out = {}
    states = cs.decode_state_sets(torch)
    la, gla = cs.recurrent_graph_times(torch, states)
    out.update(la_decode_fused=la, gla_decode_fused=gla)
    del states
    out.update(cs.paged_graph_times(torch, *cs.paged_sets(torch)))
    return out


def tile_times(tiles=(16, 32, 64)):
    """softmax_decode_fused at each of `tiles` rows (the C entry's
    tile_rows argument) in turns with DECODE_TILE_ROWS by CUDA graph
    replay: {tile: {"ms_runs", "base_ms_runs", "max_rel_err",
    "bits_of_default"}}."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels.defaults import DECODE_TILE_ROWS
    lib = build.bind(df.SOFTMAX_KERNEL, df._SOFTMAX_SYMBOLS)

    def at(tile):
        def run(q, k, v, lengths):
            o = torch.empty_like(q)
            bsz, h, _, d = q.shape
            err = lib.softmax_decode_fused(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), bsz, h, k.shape[1], k.shape[2], d, tile,
                1.0 / d ** 0.5, build.DTYPE_CODE[q.dtype],
                build.current_stream(q.device))
            build.raise_on(lib, df.SOFTMAX_KERNEL, df.SOFTMAX_KERNEL, err)
            return o
        return run

    sets = cs.paged_sets(torch)[1]
    base = at(DECODE_TILE_ROWS)(*sets[0])
    want = df.softmax_decode_fused_torch(*sets[0])
    out = {}
    for tile in tiles:
        o = at(tile)(*sets[0])
        torch.cuda.synchronize()
        err, scale = cs.rel_err(o, want)
        kern, ref = cs._graph_time_pair(torch, cs._rotating(at(tile), sets),
                                        cs._rotating(at(DECODE_TILE_ROWS),
                                                     sets))
        out[tile] = {"ms_runs": kern, "base_ms_runs": ref,
                     "max_rel_err": err / scale,
                     "bits_of_default": bool(torch.equal(o, base))}
    return out


def main():
    if len(sys.argv) == 2 and sys.argv[1] == "--tiles":
        sys.path.insert(0, str(ROOT))
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"card": card, "tiles": tile_times()}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        # chip_smoke puts this tree's src/ first on the path: the copy
        # under test goes before it
        sys.path.insert(0, str(ROOT))
        import chip_smoke  # noqa: F401
        sys.path.insert(0, sys.argv[2])
        print(json.dumps(measure()))
        return 0
    import torch
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    others = [str(Path(x).resolve()) for x in sys.argv[1:]]
    order = others + [str(ROOT / "src")] * 2 + others
    runs = []
    for src in order:
        done = subprocess.run(
            [sys.executable, __file__, "--measure", src],
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=src))
        if done.returncode != 0:
            sys.stderr.write(done.stderr)
            raise RuntimeError(f"measuring {src} failed")
        runs.append({"src": src, "ms": json.loads(
            done.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
