"""The serve steps and the greedy generation loop (counterpart of the
serving half of `repro.launch.steps`; `make_train_step` and
`init_opt_shapes` come with the training slice)."""
from __future__ import annotations

import torch

from ..models import LM, MeshCtx
from .mesh import dp_axes

__all__ = ["make_ctx", "make_prefill_step", "make_decode_step", "generate"]


def make_ctx(mesh, *, seq_sharded: bool = True) -> MeshCtx:
    return MeshCtx(mesh=mesh, dp=dp_axes(mesh), tp="model", seq_sharded=seq_sharded)


def make_prefill_step(lm: LM, ctx: MeshCtx):
    def prefill_step(params, batch):
        return lm.prefill(params, ctx, batch)
    return prefill_step


def make_decode_step(lm: LM, ctx: MeshCtx):
    def decode_step(params, token, cache, pos):
        return lm.decode_step(params, ctx, token, cache, pos)
    return decode_step


@torch.no_grad()
def generate(lm: LM, params, ctx, prompts: torch.Tensor, gen: int,
             max_len: int | None = None) -> torch.Tensor:
    """Prefill by teacher-forced decode of the prompt (B, S), then `gen`
    greedy tokens (the first maximum), on the device of `prompts`, against
    a float32 cache.  Returns (B, gen) int32 on that device; the loop never
    waits on the host."""
    b, s = prompts.shape
    max_len = max_len or (s + gen + 8)
    cache = lm.init_cache(b, max_len=max_len, dtype=torch.float32, device=prompts.device)
    step = make_decode_step(lm, ctx)
    tok = prompts[:, :1]
    out = []
    for t in range(s + gen - 1):
        logits, cache = step(params, tok, cache, t)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if t + 1 < s:
            tok = prompts[:, t + 1:t + 2]  # teacher forcing over the prompt
        else:
            tok = nxt
            out.append(nxt)
    return torch.cat(out, dim=1)
