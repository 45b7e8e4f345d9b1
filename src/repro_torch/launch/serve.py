"""Serving entry point: batched prefill + decode over a request queue.  Twin
of ``repro/launch/serve.py``.

A minimal continuous-batching server: requests are prefilled one row at
a time into a slot of a fixed-shape batched cache, then decoded
step by step together; finished slots are refilled from the queue.  It
keeps the reference's simplifications: aligned positions (every slot
decodes at the largest slot position) and ``_splice_batch``'s leaf rule,
and it prefills with the reference's default ``attn_impl`` ("auto").
It serves the dense decoder (qwen2-0.5b, KV caches) and Mamba2
(mamba2-780m): there each slot's cache is the (1, d_conv−1, conv_dim)
conv state and the (1, H, P, N) SSM state of every layer, which the
splice rule places at the slot like a KV row, and every prefill's SSD
goes through the SSD kernel on the card.  Runs where the parameters
live, under ``torch.inference_mode()``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --reduced --requests 12 --batch 4 --gen-tokens 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tmod


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Fixed-slot continuous batching (decode-only refill)."""

    def __init__(self, cfg, params, *, slots: int, max_len: int):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int32)
        self.cache = tmod.init_cache(cfg, slots, max_len,
                                     dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def _prefill_slot(self, slot: int, req: Request) -> int:
        """Prefill one slot (single-row batch, as the reference)."""
        batch = {"tokens": torch.as_tensor(req.prompt[None]).long()
                 .to(self.device)}
        row_cache = tmod.init_cache(self.cfg, 1, self.max_len,
                                    dtype=torch.float32, device=self.device)
        logits, row_cache = tmod.prefill(self.params, self.cfg, batch,
                                         row_cache)
        self.cache = {"dec": {"layers": [
            {k: _splice_batch(full[k], row[k], slot, self.slots)
             for k in full}
            for full, row in zip(self.cache["dec"]["layers"],
                                 row_cache["dec"]["layers"])]}}
        req.generated.append(int(torch.argmax(logits[0, -1])))
        return len(req.prompt)

    @torch.inference_mode()
    def step(self) -> None:
        """One decode step for all active slots."""
        toks = np.zeros((self.slots, 1), np.int64)
        for s, req in enumerate(self.active):
            if req is not None and not req.done and req.generated:
                toks[s, 0] = req.generated[-1]
        pos = int(self.pos.max())   # simplification: aligned positions
        logits, self.cache = tmod.decode_step(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            self.cache, pos)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None or req.done:
                continue
            req.generated.append(int(nxt[s]))
            if len(req.generated) >= req.max_new:
                req.done = True
        self.pos += 1

    def run(self, queue: List[Request]) -> List[Request]:
        finished: List[Request] = []
        pending = list(queue)
        while pending or any(r is not None for r in self.active):
            for s in range(self.slots):
                if self.active[s] is None and pending:
                    req = pending.pop(0)
                    self.pos[s] = self._prefill_slot(s, req)
                    self.active[s] = req
                elif self.active[s] is not None and self.active[s].done:
                    finished.append(self.active[s])
                    self.active[s] = None
            if any(r is not None and not r.done for r in self.active):
                self.step()
        return finished


def _splice_batch(full: torch.Tensor, row: torch.Tensor, slot: int,
                  slots: int) -> torch.Tensor:
    """Write a 1-row cache leaf into the batched leaf at ``slot``, by the
    reference's rule: a leaf of the row's own shape is taken from the row
    only when its leading dimension equals ``slots`` (so ``slot_pos``
    keeps the batched cache's), else the batch axis is the first of the
    leading two that is ``slots`` wide in ``full`` and 1 in ``row``.
    Writes ``full`` in place: the server owns its cache."""
    if full.shape == row.shape:
        return row if full.dim() and full.shape[0] == slots else full
    for axis in range(min(2, full.dim())):
        if full.shape[axis] == slots and row.shape[axis] == 1:
            full.narrow(axis, slot, 1).copy_(row)
            return full
    return full


def main(argv=None, *, device: DeviceLike = None) -> List[Request]:
    """The reference's command line; runs on the card unless ``device``
    (a keyword of the function, not a flag) says otherwise."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=12)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = tmod.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(0)
    queue = [Request(rid=i,
                     prompt=rng.integers(0, cfg.vocab_size,
                                         args.prompt_len).astype(np.int32),
                     max_new=args.gen_tokens)
             for i in range(args.requests)]
    server = BatchedServer(cfg, params, slots=args.batch,
                           max_len=args.prompt_len + args.gen_tokens + 4)
    t0 = time.perf_counter()
    done = server.run(queue)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:10]}")
    return done


if __name__ == "__main__":
    main()
