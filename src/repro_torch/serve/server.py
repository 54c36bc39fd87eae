"""Batched serving loop: continuous batching over a fixed-slot decode batch.

The counterpart of ``repro.serve.server``. The decode step always runs the
full [n_slots] batch; finished and empty slots ride along and their tokens
are dropped. A new request is prefilled alone and its KV is copied into a
free slot of the shared cache. Greedy decoding: ``argmax`` takes the first
maximum, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import api
from ..models.transformer import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [S]
    max_new_tokens: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class SlotServer:
    """Serves on the device that holds ``params``. ``max_len`` bounds every
    slot's cache: a prompt plus its new tokens. A slot whose request
    finishes restarts at length 0, so while it idles its length stays below
    ``max_new_tokens`` (the reference lets it grow and its cache write clamps
    at the end; ``decode_step`` here raises instead). Idle rows never touch
    the other rows' results."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 8, max_len: int = 512,
                 eos_id: int = 1):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embedding"].device
        self.cache = api.init_cache(cfg, n_slots, max_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_budget = np.zeros(n_slots, dtype=np.int64)
        self._last_token = np.zeros(n_slots, dtype=np.int32)

    # -- admission -------------------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        """Prefill the request and copy its KV into a free slot."""
        slot = self._free_slot()
        if slot is None:
            return False
        if len(req.prompt) > self.max_len:
            raise ValueError(f"request {req.rid}: prompt of {len(req.prompt)} tokens exceeds "
                             f"max_len {self.max_len}")
        toks = torch.as_tensor(np.asarray(req.prompt, dtype=np.int32)[None, :], device=self.device)
        logits, cache1 = api.serve_prefill(self.params, self.cfg, {"tokens": toks},
                                           max_len=self.max_len)
        for name in ("k", "v"):
            self.cache[name][:, slot].copy_(cache1[name][:, 0])
        self.cache["len"][slot] = cache1["len"][0]
        tok = int(torch.argmax(logits[0]))
        req.out_tokens.append(tok)
        self._last_token[slot] = tok
        self.slot_req[slot] = req
        self.slot_budget[slot] = req.max_new_tokens - 1
        return True

    # -- decode tick -------------------------------------------------------------

    def tick(self):
        """One decode step for every occupied slot."""
        if all(r is None for r in self.slot_req):
            return
        toks = torch.as_tensor(self._last_token, device=self.device)
        logits, self.cache = api.serve_decode(self.params, self.cfg, toks, self.cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self._last_token[slot] = tok
            self.slot_budget[slot] -= 1
            if tok == self.eos_id or self.slot_budget[slot] <= 0:
                req.done = True
                self.slot_req[slot] = None
                self.cache["len"][slot] = 0

    def run(self, requests: List[Request], max_ticks: int = 10_000) -> List[Request]:
        pending = list(requests)
        for _ in range(max_ticks):
            while pending and self._free_slot() is not None:
                self.admit(pending.pop(0))
            if not pending and all(r is None for r in self.slot_req):
                break
            self.tick()
        return requests
