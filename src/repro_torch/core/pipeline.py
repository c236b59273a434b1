"""Overlapping sampling with training (ScaleGNN §V-A).

Counterpart of ``repro/core/pipeline.py``. The paper builds the batch of
step t + 1 on a dedicated CUDA stream while step t's forward and backward
run, joined by an event, and carries the overlap across epoch
boundaries; the reference, on a TPU without user streams, folds the next
batch into the jitted step instead. Here it is the paper's design: the
carried state is ``(params, opt_state, minibatch_t)``, and one step

    batch' = build(step + 1)                      # on the side stream
    grads  = grad(loss)(params, minibatch_t)      # on the main stream
    params = optimizer(params, grads)

with the main stream waiting on the side stream's event before it
consumes ``batch'``. The build forks before the forward: it needs only
the step counter, so it overlaps the whole forward and backward. The
batch is a pure function of (seed, epoch, step, dp), so prefetch on and
off give the same losses bit for bit. The side stream forks from the
main stream at every build (it waits on the main stream's position) and
the main stream joins it by an event, so a build inside a CUDA graph
capture becomes a parallel branch of the graph. The step counter it
builds from may be a device tensor: nothing is read on the host. Every
tensor that crosses streams is marked with ``record_stream``, so that the
caching allocator does not hand its memory out again before the other
stream is done with it: the build's tensor arguments (a temporary such as
``step + 1``, allocated on the main stream and freed when the build
returns) for the side stream, and the batch's tensors (allocated on the
side stream) for the main one. Inside a capture that also keeps a freed
argument's block from being given to a later allocation of the main
branch, which nothing in the graph orders after the side branch's read.
On the CPU the same code runs inline.
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

    def build(self, fn: Callable[..., Minibatch], *args) -> Minibatch:
        """``fn(*args)`` on the side stream, forked from the main stream's
        current position, its event recorded; the tensor arguments marked
        as used by the side stream and the result's tensors as used by the
        main stream."""
        if self.stream is None:
            return fn(*args)
        main = torch.cuda.current_stream(self.stream.device)
        for a in args:
            if isinstance(a, torch.Tensor):
                a.record_stream(self.stream)
        self.stream.wait_stream(main)
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
      rank's batch ``step`` (an int or a device counter); ``epoch``
      defaults to the epoch the step falls in, so a batch prefetched from
      an epoch's last step comes from the next epoch's permutation (the
      carry crosses epoch boundaries);
    * ``loss_fn`` is the plan's ``fourd.LossFn``: ``loss_fn(params, None,
      step, mb=batch, ef=None)`` gives the (G_d,) losses of a carried
      batch, and ``fourd.value_and_grad(loss_fn, params, None, step,
      mb=batch)`` its gradient.
    """
    loss_fn = fourd.make_loss_fn(plan, train=True)

    def sample_fn(graph, step, epoch=None) -> Minibatch:
        if epoch is None:
            epoch = plan.builder.epoch_of(step)
        return loss_fn.sample(graph, step, epoch)
    return sample_fn, loss_fn


def make_prefetched_train_step(plan: fourd.FourDPlan, optimizer):
    """``(sample_fn, step_fn)``: ``sample_fn(graph, step)`` builds batch
    ``step`` (once, for the warm-up); ``step_fn(state, graph, step)`` forks
    the build of batch ``step + 1`` onto the side stream, consumes the
    carried batch, applies the optimizer in place, joins the build and
    returns ``(state', loss)``."""
    sample_fn, loss_fn = make_pipeline_fns(plan)
    side = SideStream(plan.device)

    def step_fn(state: PrefetchState, graph, step):
        next_mb = side.build(sample_fn, graph, step + 1)
        loss, grads = fourd.value_and_grad(loss_fn, state.params, graph,
                                           step, mb=state.minibatch)
        params, opt_state = optimizer.update(state.params, grads,
                                             state.opt_state,
                                             sumsq=plan.global_sumsq)
        side.join()
        return PrefetchState(params, opt_state, next_mb), loss
    return sample_fn, step_fn
