"""Continuous-batching traffic harness (port of ``repro.serve.traffic``).

- :class:`TrafficGen` — a deterministic request stream. Arrivals, prompt
  lengths, prompt tokens and output budgets are pure hashes of
  ``(seed, request_index)`` through the port's copy of the hetero hash
  family, so the stream equals the reference's bit for bit and replays
  exactly after a restart. ``mode="poisson"`` draws exponential
  inter-arrival gaps (rate = requests per decode boundary); ``"staggered"``
  spaces arrivals exactly ``1/rate`` apart.

- :class:`ContinuousBatcher` — per-token-boundary slot refill over a
  :class:`repro_torch.serve.LiveServer`. The KV cache has ONE global write
  position shared by all batch rows, so each slot carries ``kv_start[b]``,
  the position at which its request was admitted, and the decode program
  masks every cache position below it (kernel B9 skips them): a request
  admitted into a recycled slot never sees the previous occupant's rows.
  Admitted slots' cache rows are also zeroed, IN PLACE (the reference runs
  a donated jitted pass). Prompts go in through the decode path itself, one
  prompt token per boundary, then greedy argmax generation until the
  request's ``max_new`` budget is spent; a request is admitted only if its
  whole ``prompt_len + max_new`` span fits below ``max_len``. Times are in
  boundary units.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.hetero.models import hetero_hash, hetero_uniform

PyTree = Any

# salts partition the per-request hash stream (one lane per quantity)
_SALT_GAP, _SALT_PLEN, _SALT_MAXNEW, _SALT_TOKENS = 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: int            # boundary index the request becomes visible
    prompt: np.ndarray      # int32 [prompt_len] token ids
    max_new: int            # generation budget (tokens)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class TrafficGen:
    """Hash-seeded request stream (see module docstring).

    rate is requests per decode boundary; prompt_len / max_new are inclusive
    (lo, hi) ranges sampled uniformly per request.
    """

    def __init__(self, seed: int, *, rate: float, num_requests: int,
                 vocab: int, prompt_len=(1, 8), max_new=(4, 16),
                 mode: str = "poisson"):
        assert mode in ("poisson", "staggered"), mode
        assert rate > 0 and num_requests >= 0
        self.seed = seed
        self.rate = float(rate)
        self.num_requests = int(num_requests)
        self.vocab = int(vocab)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new = (int(max_new[0]), int(max_new[1]))
        self.mode = mode

    def _span(self, rng, i: int, salt: int) -> int:
        lo, hi = rng
        return lo + int(hetero_hash(self.seed, i, 0, salt) % (hi - lo + 1))

    def requests(self) -> List[Request]:
        reqs = []
        t = 0.0
        for i in range(self.num_requests):
            if self.mode == "poisson":
                u = float(hetero_uniform(self.seed, i, 0, _SALT_GAP))
                t += -np.log(u) / self.rate     # exponential gap, rate/boundary
            else:
                t += 1.0 / self.rate
            plen = self._span(self.prompt_len, i, _SALT_PLEN)
            prompt = (hetero_hash(self.seed, i, np.arange(plen), _SALT_TOKENS)
                      % self.vocab).astype(np.int32)
            reqs.append(Request(rid=i, arrival=int(np.floor(t)), prompt=prompt,
                                max_new=self._span(self.max_new, i, _SALT_MAXNEW)))
        return reqs


@dataclasses.dataclass
class _Slot:
    req: Request
    admit: int                    # boundary admitted
    fed: int = 0                  # prompt+generated tokens fed so far
    generated: Optional[List[int]] = None
    first_token: Optional[int] = None

    def __post_init__(self):
        if self.generated is None:
            self.generated = []


class ContinuousBatcher:
    """Per-token-boundary continuous batching over a LiveServer."""

    def __init__(self, server, requests: List[Request], cond=None):
        prog = server.program
        assert prog.model_cfg.audio is None and prog.model_cfg.vlm is None, (
            "the continuous-batching harness drives plain-LM token streams")
        self.server = server
        self.cond = cond
        self.B = prog.batch
        self.max_len = prog.max_len
        self.vocab = prog.model_cfg.vocab_size
        self.cache = server.init_cache()
        self.pos = 0                                 # host mirror of cache pos
        self.slots: List[Optional[_Slot]] = [None] * self.B
        self.kv_start = np.zeros(self.B, np.int32)
        self.next_tok = np.zeros(self.B, np.int32)
        self.pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        self.completed: List[Dict[str, Any]] = []
        self.admitted = 0
        self.boundaries_run = 0
        self._dev = prog.device

    def _reset(self, keep: np.ndarray) -> None:
        """Zero the cache rows of every slot whose ``keep`` is False, in
        place, over the ``[count, B, ...]`` stacks: the segments' and the
        hybrid's shared sites'. A recurrent state has no position axis for
        ``kv_start`` to mask, so this reset is what isolates a new request."""
        mask = torch.as_tensor(keep, device=self._dev)
        stacks = list(self.cache["segments"].values())
        if "shared_sites" in self.cache:
            stacks.append(self.cache["shared_sites"])
        for seg in stacks:
            for a in seg.values():
                a.mul_(mask.reshape((1, -1) + (1,) * (a.ndim - 2)).to(a.dtype))

    # ------------------------------------------------------------- admission
    def _admit(self, boundary: int) -> bool:
        """Fill free slots from the arrived backlog; returns True if any slot
        was admitted (its cache rows then need the masked reset)."""
        any_new = False
        for b in range(self.B):
            if self.slots[b] is not None or not self.pending:
                continue
            nxt = self.pending[0]
            if nxt.arrival > boundary:
                break               # queue is arrival-sorted: nothing visible
            # capacity: the full span must fit under the shared write head
            if self.pos + nxt.prompt_len + nxt.max_new > self.max_len:
                break
            req = self.pending.popleft()
            self.slots[b] = _Slot(req=req, admit=boundary)
            self.kv_start[b] = self.pos
            self.next_tok[b] = req.prompt[0]
            self.admitted += 1
            any_new = True
        return any_new

    # ---------------------------------------------------------- one boundary
    def step(self, boundary: int) -> None:
        """One decode boundary: admit, isolate, decode, refill."""
        assert self.pos < self.max_len, "cache exhausted: raise max_len"
        fresh = self._admit(boundary)
        keep = np.array([s is not None and s.fed > 0 for s in self.slots])
        for b in range(self.B):
            if self.slots[b] is None:
                # free slot: bound attention to the row being written this
                # boundary — one visible (garbage, ignored) position, so the
                # softmax never sees an all-masked row
                self.kv_start[b] = self.pos
                self.next_tok[b] = 0
        if fresh:
            self._reset(keep)
        logits, self.cache = self.server.decode(
            self.cache, torch.as_tensor(self.next_tok, device=self._dev)[:, None],
            self.cond, torch.as_tensor(self.kv_start, device=self._dev))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()   # greedy
        self.pos += 1
        self.boundaries_run += 1
        for b, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.fed += 1
            if slot.fed < slot.req.prompt_len:
                self.next_tok[b] = slot.req.prompt[slot.fed]   # still prefill
                continue
            tok = int(nxt[b])
            slot.generated.append(tok)
            if slot.first_token is None:
                slot.first_token = boundary
            if len(slot.generated) >= slot.req.max_new:
                self.completed.append({
                    "rid": slot.req.rid, "arrival": slot.req.arrival,
                    "admit": slot.admit, "first_token": slot.first_token,
                    "done": boundary, "prompt_len": slot.req.prompt_len,
                    "tokens": list(slot.generated)})
                self.slots[b] = None
            else:
                self.next_tok[b] = tok

    def run(self, boundaries: int, on_boundary=None) -> None:
        """Drive ``boundaries`` decode boundaries; ``on_boundary(t)`` (if
        given) runs BEFORE each boundary — the train-while-serve interleaving
        point (train slice + hot swap)."""
        for t in range(self.boundaries_run, self.boundaries_run + boundaries):
            if self.pos >= self.max_len:
                break
            if on_boundary is not None:
                on_boundary(t)
            self.step(t)

    # ------------------------------------------------------------ accounting
    @property
    def in_flight(self) -> int:
        return sum(s is not None for s in self.slots)

    def check_invariants(self) -> None:
        """Raises unless the harness bookkeeping is consistent: no slot leak
        (every admitted request is either completed or still occupying
        exactly one slot) and every completed request got its full budget."""
        assert self.admitted == len(self.completed) + self.in_flight, (
            "slot leak", self.admitted, len(self.completed), self.in_flight)
        live = [s.req.rid for s in self.slots if s is not None]
        assert len(live) == len(set(live)), ("request in two slots", live)
        done = [r["rid"] for r in self.completed]
        assert len(done) == len(set(done)), ("request completed twice", done)
        assert not (set(done) & set(live)), "completed request still in a slot"
        for r in self.completed:
            assert r["arrival"] <= r["admit"] <= r["first_token"] <= r["done"]

    def latency_summary(self) -> dict:
        """Boundary-unit latency stats over completed requests: time-to-first
        -token (from arrival) and total turnaround."""
        if not self.completed:
            return {"completed": 0, "admitted": self.admitted}
        ttft = np.array([r["first_token"] - r["arrival"] for r in self.completed],
                        np.float64)
        full = np.array([r["done"] - r["arrival"] for r in self.completed],
                        np.float64)
        gen = sum(len(r["tokens"]) for r in self.completed)
        return {"completed": len(self.completed), "admitted": self.admitted,
                "pending": len(self.pending), "in_flight": self.in_flight,
                "generated_tokens": gen,
                "ttft_p50_boundaries": float(np.percentile(ttft, 50)),
                "ttft_p99_boundaries": float(np.percentile(ttft, 99)),
                "latency_p50_boundaries": float(np.percentile(full, 50)),
                "latency_p99_boundaries": float(np.percentile(full, 99))}
