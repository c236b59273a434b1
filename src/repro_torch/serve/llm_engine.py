"""Autoregressive LLM serving on one GPU: KV-cache slot scheduling over
``models/transformer.py``.

Counterpart of ``repro/serve/llm_engine.py``, with the same scheduling.
The unit of admission is a prompt, the unit of capacity a **KV cache
slot** — one row of a pooled slot cache (``T.init_slot_cache``), claimed at
prefill and held until the sequence finishes. Scheduling is continuous
batching at sequence granularity:

* a queued prompt claims any free slot and is **prefilled into it
  mid-stream** (``T.prefill_into_slot``, whose attention is the CUDA flash
  kernel), emitting its first token;
* ONE ``T.decode_step_slots`` per pump advances every active slot in a
  packed batch and emits one completion per active sequence;
* a finished sequence (max tokens or EOS) frees its slot immediately; the
  next waiting prompt takes it while its neighbors keep decoding.

``continuous=False`` is the static-batching foil: slots are claimed only
when the whole pool is idle, so every wave decodes until its slowest member
finishes.

The reference counts jit traces (``prefill_compiles``,
``decode_compiles``) to prove that no request recompiles; PyTorch runs
eagerly and compiles nothing per request, so those counters are dropped.
The engine runs on the card unless ``LLMServeOptions.device`` names the
CPU; with no card it raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, use_full_f32_matmul
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import LatencyHistogram
from repro_torch.serve.batcher import RequestQueue
from repro_torch.serve.core import ServingCore
from repro_torch.serve.protocol import Completion, PendingRequest

# batch tags at the protocol seam (opaque to the core)
_PREFILL = "prefill"
_DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class LLMServeOptions:
    """Knobs of the LLM serving path."""

    slots: int = 4              # KV cache pool size = max concurrent seqs
    max_prompt_len: int = 32    # static prompt capacity (prompts right-pad)
    max_new_tokens: int = 16    # generation budget per request
    continuous: bool = True     # False = static batching (benchmark foil)
    eos_id: Optional[int] = None    # early stop on this token id
    replay: bool = False        # virtual clock; deterministic replays
    # None = the card; "cpu" runs every kernel's plain version
    device: Optional[str] = None


class LLMBackend:
    """Slot-scheduled autoregressive decoding behind the serving protocol.
    ``params`` (a ``T.Transformer``) is moved to the engine's device."""

    def __init__(self, params: T.Transformer, cfg: ModelConfig,
                 options: LLMServeOptions = LLMServeOptions()):
        self.device = resolve_device(options.device)
        use_full_f32_matmul()
        self.cfg = cfg
        self.opts = options
        self._params = params.to(self.device)
        max_len = options.max_prompt_len + options.max_new_tokens
        self._cache = T.init_slot_cache(cfg, options.slots, max_len,
                                        self.device)
        self._queue = RequestQueue()

        n = options.slots
        self._slot_rid: List[Optional[int]] = [None] * n
        self._slot_emitted = [0] * n         # tokens emitted per sequence
        self._slot_tok = [0] * n             # last emitted token (decode fed)
        self._slot_gen = [0] * n             # sequences this slot has served

        self.device_calls = 0
        self.prefills = 0
        self.decode_steps = 0
        self.mid_stream_refills = 0          # slot reuses while others decode
        self._occ_active = 0                 # active slots summed over steps
        self.prefill_lat = LatencyHistogram()    # per-prefill device time
        self.decode_lat = LatencyHistogram()     # per-decode-step device time

    # -- protocol ------------------------------------------------------------

    def capacity(self) -> int:
        return self.opts.slots

    def validate(self, payload: Sequence[int]) -> None:
        toks = [int(t) for t in payload]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) > self.opts.max_prompt_len:
            raise ValueError(f"prompt of {len(toks)} tokens exceeds "
                             f"max_prompt_len={self.opts.max_prompt_len}")
        if not all(0 <= t < self.cfg.vocab for t in toks):
            raise ValueError("token id out of the vocabulary")

    def new_request(self, payload: Sequence[int]) -> np.ndarray:
        return np.zeros((self.opts.max_new_tokens,), np.int32)

    def admit(self, req: PendingRequest, now: float) -> List[Any]:
        self._queue.add(req.rid, np.asarray([int(t) for t in req.payload],
                                            np.int32))
        return self._schedule()

    def plan(self, now: float, force: bool) -> List[Any]:
        batches = self._schedule()
        if any(r is not None for r in self._slot_rid):
            batches.append((_DECODE,))
        return batches

    def execute(self, batch: Any, now: float) -> List[Completion]:
        if batch[0] == _PREFILL:
            return self._exec_prefill(batch)
        return self._exec_decode()

    def cancel(self, rid: int) -> None:
        self._queue.cancel(rid)
        for i, r in enumerate(self._slot_rid):
            if r == rid:
                self._slot_rid[i] = None     # freed; cache rows masked out

    def busy(self) -> bool:
        # active decode slots make every pump productive
        return any(r is not None for r in self._slot_rid)

    def update_params(self, params: T.Transformer) -> None:
        # in-flight sequences continue on the new weights from their next
        # token (their KV prefix was built by the old ones)
        self._params = params.to(self.device)

    def invalidate(self) -> None:
        pass    # no cross-request derived state: the KV cache is per-seq

    # -- scheduling ----------------------------------------------------------

    def _n_active(self) -> int:
        return sum(r is not None for r in self._slot_rid)

    def _schedule(self) -> List[Any]:
        """Claim free slots for waiting prompts (FIFO). Continuous mode
        refills anytime; static mode only starts a wave on an idle pool."""
        if not self.opts.continuous and self._n_active() > 0:
            return []
        # refill = claiming a previously-used slot while sequences admitted
        # BEFORE this scheduling turn are still decoding (claims within one
        # turn are a wave, not a refill)
        decoding_before = self._n_active() > 0
        batches = []
        for i in range(self.opts.slots):
            if not self._queue.pending:
                break
            if self._slot_rid[i] is not None:
                continue
            rid, toks = self._queue.pop()
            if self._slot_gen[i] > 0 and decoding_before:
                self.mid_stream_refills += 1
            self._slot_rid[i] = rid
            self._slot_emitted[i] = 0
            self._slot_gen[i] += 1
            batches.append((_PREFILL, rid, i, toks))
        return batches

    def _emit(self, i: int, tok: int) -> Completion:
        """Record token ``tok`` for slot ``i``'s sequence; free on final."""
        rid = self._slot_rid[i]
        pos = self._slot_emitted[i]
        self._slot_emitted[i] += 1
        self._slot_tok[i] = tok
        final = (self._slot_emitted[i] >= self.opts.max_new_tokens
                 or tok == self.opts.eos_id)
        if final:
            self._slot_rid[i] = None
        return Completion(rid, pos, np.int32(tok), final)

    # -- device calls --------------------------------------------------------

    def _exec_prefill(self, batch) -> List[Completion]:
        _, rid, slot, toks = batch
        if self._slot_rid[slot] != rid:
            return []                        # shed between plan and execute
        padded = np.zeros((1, self.opts.max_prompt_len), np.int32)
        padded[0, :len(toks)] = toks
        t0 = time.monotonic()
        tok, _, self._cache = T.prefill_into_slot(
            self._params, torch.from_numpy(padded).to(self.device),
            len(toks), self._cache, slot, self.cfg)
        tok = int(tok[0])                    # waits for the device
        self.prefill_lat.observe(time.monotonic() - t0)
        self.device_calls += 1
        self.prefills += 1
        return [self._emit(slot, tok)]

    def _exec_decode(self) -> List[Completion]:
        active = [r is not None for r in self._slot_rid]
        if not any(active):
            return []                        # every slot shed since plan
        t0 = time.monotonic()
        toks, _, self._cache = T.decode_step_slots(
            self._params,
            torch.tensor(self._slot_tok, dtype=torch.int32,
                         device=self.device)[:, None],
            self._cache, self.cfg,
            torch.tensor(active, device=self.device))
        toks = toks.cpu().numpy()            # waits for the device
        self.decode_lat.observe(time.monotonic() - t0)
        self.device_calls += 1
        self.decode_steps += 1
        self._occ_active += sum(active)
        return [self._emit(i, int(toks[i]))
                for i in range(self.opts.slots) if active[i]]

    # -- stats ---------------------------------------------------------------

    def reset_stats(self) -> None:
        self.device_calls = 0
        self.prefills = 0
        self.decode_steps = 0
        self.mid_stream_refills = 0
        self._occ_active = 0
        self.prefill_lat = LatencyHistogram()
        self.decode_lat = LatencyHistogram()

    def stats(self) -> dict:
        pre = self.prefill_lat.snapshot()
        dec = self.decode_lat.snapshot()
        steps = self.decode_steps
        return {
            "prefills": self.prefills,
            "decode_steps": steps,
            "queued": self._queue.pending,
            "wait_high_water": self._queue.wait_high_water,
            "active_slots": self._n_active(),
            # mean fraction of the pool doing useful work per decode step;
            # the complement is the padding the packed batch computes anyway
            "slot_occupancy": (self._occ_active / (steps * self.opts.slots)
                               if steps else 0.0),
            "mid_stream_refills": self.mid_stream_refills,
            "prefill_p50_ms": pre["p50_ms"],
            "prefill_p95_ms": pre["p95_ms"],
            "prefill_mean_ms": pre["mean_ms"],
            "decode_p50_ms": dec["p50_ms"],
            "decode_p95_ms": dec["p95_ms"],
            "decode_mean_ms": dec["mean_ms"],
        }


class LLMEngine(ServingCore):
    """Serve "generate from this prompt" requests against a transformer.

    ``submit(token_ids)`` returns a request id whose output is the (up to
    ``max_new_tokens``, EOS-truncated) greedy continuation as an int32
    array. Same lifecycle as the GNN engine — submit/pump/poll/drain — but
    ``pump`` advances ALL active sequences one token, so completions arrive
    in bursts."""

    def __init__(self, params: T.Transformer, cfg: ModelConfig,
                 options: LLMServeOptions = LLMServeOptions()):
        backend = LLMBackend(params, cfg, options)
        super().__init__(backend, replay=options.replay)
        self.backend = backend
        self.cfg = cfg
        self.opts = options

    def generate(self, prompts: Sequence[Sequence[int]],
                 now: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous convenience: submit every prompt, drain, return the
        completions in prompt order."""
        rids = [self.submit(p, now) for p in prompts]
        self.drain(now)
        done = self.take_completed()
        return [done[r] for r in rids]
