"""Overlapping sampling with training (ScaleGNN §V-A).

Counterpart of ``repro/core/pipeline.py``. The paper builds the batch of
step t + 1 on a dedicated CUDA stream while step t's forward and backward
run, joined by an event, and carries the overlap across epoch
boundaries; the reference, on a TPU without user streams, folds the next
batch into the jitted step instead. Here it is the paper's design: the
carried state is ``(params, opt_state, minibatch_t)``, and one step

    grads  = grad(loss)(params, minibatch_t)      # enqueued on the main stream
    batch' = build(step + 1)                      # on the side stream
    params = optimizer(params, grads)

with the main stream waiting on the side stream's event before it
consumes ``batch'``. The batch is a pure function of (seed, epoch, step,
dp), so prefetch on and off give the same losses bit for bit. The batch's
tensors are allocated on the side stream and read on the main one, so
each is marked with ``record_stream``: the caching allocator then does
not hand their memory out again before the main stream is done with them.
On the CPU the same code runs inline.

The extraction's block-ELL conversion reads a count back to the host
(``kernels.spmm_ell.dense_to_block_ell_ranked``), so the host waits
inside the prefetch until the side stream has drained up to it; the main
stream's work, already enqueued, runs on meanwhile.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import fourd
from repro_torch.core.minibatch import Minibatch
from repro_torch.tree import leaves


@dataclasses.dataclass
class PrefetchState:
    params: Any
    opt_state: Any
    minibatch: Minibatch     # batch t, carried into step t (this rank's)


class SideStream:
    """Runs a batch build on a side CUDA stream of ``device`` and lets the
    main stream wait for it (:meth:`join`); inline on the CPU."""

    def __init__(self, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.ready: Optional[torch.cuda.Event] = None
        self._primed = False

    def build(self, fn: Callable[..., Minibatch], *args) -> Minibatch:
        """``fn(*args)`` on the side stream, its event recorded; the
        result's tensors marked as used by the main stream."""
        if self.stream is None:
            return fn(*args)
        main = torch.cuda.current_stream(self.stream.device)
        if not self._primed:
            # once: the graph the sampler reads was put on the card by the
            # main stream
            self.stream.wait_stream(main)
            self._primed = True
        with torch.cuda.stream(self.stream):
            mb = fn(*args)
            self.ready = torch.cuda.Event()
            self.ready.record(self.stream)
        for t in leaves(mb):
            t.record_stream(main)
        return mb

    def join(self) -> None:
        """Make the main stream wait for the last build (a no-op when
        none is in flight, and on the CPU)."""
        if self.ready is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(
                self.ready)
            self.ready = None


def make_pipeline_fns(plan: fourd.FourDPlan):
    """The two halves of the §V-A pipeline, shared by
    :func:`make_prefetched_train_step` and ``train.Trainer``:

    * ``sample_fn(graph, step, epoch=None) -> Minibatch`` builds this
      rank's batch ``step``; ``epoch`` defaults to the epoch the step falls
      in, so a batch prefetched from an epoch's last step comes from the
      next epoch's permutation (the carry crosses epoch boundaries);
    * ``loss_fn`` is the plan's ``fourd.LossFn``: ``loss_fn(params, None,
      step, mb=batch, ef=None)`` gives the (G_d,) losses of a carried
      batch, and ``fourd.value_and_grad(loss_fn, params, None, step,
      mb=batch)`` its gradient.
    """
    loss_fn = fourd.make_loss_fn(plan, train=True)

    def sample_fn(graph, step, epoch=None) -> Minibatch:
        if epoch is None:
            epoch = plan.builder.epoch_of(int(step))
        return loss_fn.sample(graph, step, epoch)
    return sample_fn, loss_fn


def make_prefetched_train_step(plan: fourd.FourDPlan, optimizer):
    """``(sample_fn, step_fn)``: ``sample_fn(graph, step)`` builds batch
    ``step`` (once, for the warm-up); ``step_fn(state, graph, step)``
    consumes the carried batch, builds batch ``step + 1`` on the side
    stream after the forward and backward are enqueued, applies the
    optimizer in place and returns ``(state', loss)``."""
    sample_fn, loss_fn = make_pipeline_fns(plan)
    side = SideStream(plan.device)

    def step_fn(state: PrefetchState, graph, step):
        side.join()
        loss, grads = fourd.value_and_grad(loss_fn, state.params, graph,
                                           step, mb=state.minibatch)
        next_mb = side.build(sample_fn, graph, int(step) + 1)
        params, opt_state = optimizer.update(state.params, grads,
                                             state.opt_state,
                                             sumsq=plan.global_sumsq)
        return PrefetchState(params, opt_state, next_mb), loss
    return sample_fn, step_fn
