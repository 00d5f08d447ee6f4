"""Continuous batching over fixed decode slots for an LM (port of
``repro/runtime/server.py``).

* ``num_slots`` decode lanes share one serve step: every tick advances
  every active slot by one token in one model call, with per-slot cache
  cursors (a (B,) index tensor: each layer writes each slot's row at its
  own position and the decode kernel bounds each slot by its own cursor).
  Newly admitted requests prefill token by token while older ones keep
  decoding, with no head-of-line blocking.
* Retired slots are re-admitted at once. Their stale rows are unreachable:
  the new request's cursor restarts at 0 and the decode reads no row at or
  past a slot's cursor. An SSM's recurrent state has no cursor, so
  admission zeroes the slot's (``model.reset_slots``). The reference
  resets only the cursor, so there a re-admitted request of hymba or
  rwkv6 starts from the slot's last state (free slots are decoded every
  tick, so that state drifts): a deliberate difference.

Sampling stays on the host, from the last-token logits, greedy or at a
temperature, with the reference's numpy generator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.runtime.steps import make_serve_step


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: Optional[List[int]] = None

    @property
    def text_len(self) -> int:
        return len(self.prompt) + len(self.generated or ())


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    cursor: int = 0                 # tokens written into this slot's cache
    prefill_pos: int = 0            # next prompt token to feed


class Server:
    def __init__(self, model, *, num_slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 cache_dtype=torch.float32):
        """``model``: a ``TransformerLM`` (its device is the server's).
        ``cache_dtype``: a torch dtype or "float32" / "bfloat16" / "int8"
        (int8 carries per-row scales and dequantizes inside the decode
        kernel, see ``Attention.init_cache``)."""
        self.model = model
        self.device = model.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.rng = np.random.default_rng(seed)
        self.cache = model.init_cache(num_slots, max_len, cache_dtype)
        self.slots = [_Slot() for _ in range(num_slots)]
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.ticks = 0
        self._decode = make_serve_step(model)

    # -- admission -----------------------------------------------------------
    def submit(self, request: Request):
        request.generated = []
        self.queue.append(request)

    def _admit(self):
        admitted = []
        for i, slot in enumerate(self.slots):
            if slot.request is None and self.queue:
                slot.request = self.queue.pop(0)
                slot.cursor = 0
                slot.prefill_pos = 0
                admitted.append(i)
        if admitted:
            self.model.reset_slots(self.cache, admitted)

    # -- main loop -----------------------------------------------------------
    def step(self):
        """One tick: admit, advance every active slot one token, retire.
        Free slots are decoded too (token 0 at row 0), as the reference's
        are, and their outputs discarded."""
        self._admit()
        tokens = np.zeros((self.num_slots, 1), np.int32)
        index = np.zeros(self.num_slots, np.int32)
        active = []
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None:
                continue
            active.append(i)
            index[i] = slot.cursor
            if slot.prefill_pos < len(req.prompt):
                tokens[i, 0] = req.prompt[slot.prefill_pos]
            else:
                tokens[i, 0] = req.generated[-1]
        if not active:
            return
        logits, self.cache = self._decode(
            self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(index).to(self.device))
        logits = logits.to(torch.float32).cpu().numpy()
        self.ticks += 1
        for i in active:
            slot = self.slots[i]
            req = slot.request
            slot.cursor += 1
            if slot.prefill_pos < len(req.prompt):
                slot.prefill_pos += 1
                if slot.prefill_pos < len(req.prompt):
                    continue                      # still prefilling
            tok = self._sample(logits[i], req)
            req.generated.append(tok)
            finished = (len(req.generated) >= req.max_new_tokens
                        or (self.eos_id is not None and tok == self.eos_id)
                        or slot.cursor >= self.max_len - 1)
            if finished:
                self.done[req.uid] = req
                slot.request = None

    def _sample(self, logits: np.ndarray, req: Request) -> int:
        if req.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / req.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def run_until_drained(self, max_ticks: int = 10_000):
        while (self.queue or any(s.request for s in self.slots)) \
                and self.ticks < max_ticks:
            self.step()
        return self.done
