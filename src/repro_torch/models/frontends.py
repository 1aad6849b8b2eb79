"""Modality frontends: deterministic stubs (port of
`repro/models/frontends.py`).

whisper-large-v3 and qwen2-vl-7b are specified as transformer backbones:
the encoder takes precomputed frame embeddings and the decoder M-RoPE
positions, so these stubs make plausible inputs and need no weights.  A
real deployment would put the conv mel-spectrogram frontend (whisper) or
the ViT patchifier (qwen2-vl) in their place.
"""
from __future__ import annotations

import torch


def audio_frames_stub(gen: torch.Generator, batch: int, num_frames: int,
                      d_model: int, dtype=torch.float32):
    """Stand-in for whisper's conv1d(mel) encoder input: N(0, 0.02^2)
    frames (B, T, d_model), drawn from `gen` on its device."""
    return (torch.randn((batch, num_frames, d_model), generator=gen,
                        dtype=torch.float32, device=gen.device)
            * 0.02).to(dtype)


def vision_positions_stub(batch: int, seq_len: int, grid=(1, 16, 16),
                          device=None):
    """M-RoPE (t, h, w) positions of an image+text stream: int32 (3, B,
    N).

    The first grid[0] * grid[1] * grid[2] tokens are image patches laid
    out on the (t, h, w) grid; the rest are text, all three streams equal
    and continuing from the largest temporal position + 1 (qwen2-vl's
    convention, as the reference's stub).
    """
    t, h, w = grid
    n_img = min(t * h * w, seq_len)
    idx = torch.arange(n_img, device=device)
    tpos, hpos, wpos = idx // (h * w), (idx // w) % h, idx % w
    start = int(tpos.max()) + 1 if n_img else 0
    text = torch.arange(seq_len - n_img, device=device) + start
    pos3 = torch.stack([torch.cat([tpos, text]), torch.cat([hpos, text]),
                        torch.cat([wpos, text])]).to(torch.int32)
    return pos3[:, None].expand(3, batch, seq_len)


class StubBatches:
    """A token stream's batches with what the family's frontend adds, as
    tensors on `device`: M-RoPE positions (3, B, N) of an image of `grid`
    patches then text, or encoder frames (B, T, d) from
    `audio_frames_stub`, seeded by the batch index.  `data` is a
    `SyntheticLM` (`batch_at(i)` gives numpy tokens (B, N))."""

    def __init__(self, cfg, data, grid=(1, 16, 16), device="cuda"):
        self.cfg, self.data, self.device = cfg, data, torch.device(device)
        self.positions = (vision_positions_stub(
            data.host_batch, data.seq, grid, self.device)
            if cfg.rope_kind == "mrope" else None)

    def batch_at(self, i: int) -> dict:
        batch = {"tokens": torch.from_numpy(self.data.batch_at(i)).to(
            self.device)}
        if self.positions is not None:
            batch["positions"] = self.positions
        if self.cfg.family == "encdec":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(1000 + i)
            batch["frames"] = audio_frames_stub(
                gen, self.data.host_batch, self.cfg.encoder_seq,
                self.cfg.d_model)
        return batch
