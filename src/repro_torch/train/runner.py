"""The chunked training runtime.

Counterpart of ``repro/train/runner.py``. ``Trainer`` runs a plan's steps
on this rank of the plan's mesh, in chunks of ``chunk_size``. One step
(:meth:`Trainer.step`): sample + extract + forward + loss
(``fourd.make_loss_fn``), the backward through the kernels' autograd
rules and the mesh's collectives (``fourd.value_and_grad``), the
optimizer update of the rank's shards in place, clipped by the global
norm over the shards, and the step and epoch counters advanced in place
on the device. No host reads a device value inside the step.

**On the card, a chunk is replays of one captured step** — the
reference's ``compiled_chunk``, whose ``lax.scan`` runs ``chunk_size``
steps per host dispatch. ``run()`` captures ONE optimizer step in a
``torch.cuda.CUDAGraph`` (the scan body) and replays it once per step, so
a remainder chunk needs no second capture:

* **warm-up** — the first step of a run whose state the graph does not
  hold runs eagerly, a real step (the captured body, so the same bits):
  it builds the kernels, sets their attributes, creates the NCCL
  communicators and fills the allocator. Then the step is captured, which
  runs nothing;
* **static buffers** — the params, the optimizer state, the counters and
  the carries are the graph's buffers and each replay updates them in
  place (the reference's donation); after each replay an eager ``copy_``
  moves its loss into the chunk's ``(n,)`` buffer on the device, and the
  losses are read once, when ``run()`` ends;
* **the host's mirror of the step** — a Python count, advanced per
  replay, sets the eval, checkpoint and target boundaries; the device
  counter is never read for them;
* **no fallback** — a failed capture or replay raises, and so does a
  run at g > 1 under an option that makes point-to-point hops (the
  rings, the quantized wires, the permute reshard): those hops have not
  run inside a graph yet, and ``Trainer.step`` drives them eagerly.

A new state object (a restore, another run's) or another graph dict is
captured again; ``restore()`` drops the old graph. On the CPU ``run()``
runs the same body eagerly: the CPU has no graphs. :meth:`Trainer.step`
stays the eager step on either device, the yardstick a captured run is
held against.

The cadences and restore rules are the reference's:

* **eval at chunk boundaries** — one eval per report boundary, used for
  both the report and the target-accuracy stop;
* **full-state checkpoint/resume** — ``save()`` writes the whole
  ``TrainState`` with global (unsharded) params and optimizer moments, as
  the reference's global arrays are: every rank takes part in the gathers
  and rank 0 writes. ``restore()`` reads it on every rank and slices the
  rank's shards, so a checkpoint of one card resumes on a mesh and back.
  ``restore()`` + ``run()`` continue the run bit for bit, on the CPU and
  on the card, because the sample and the dropout masks are pure
  functions of ``(seed, epoch, step)``, both counters travel in the state
  and every kernel of the step is deterministic. ``run()`` always persists
  the final state when a checkpoint directory is configured;
* **async checkpointing** — a mid-run save gathers the state and
  snapshots it with ``.clone()`` on the device, queued on the current
  stream before the next replay or step (which overwrite the state's
  buffers), and a worker thread of rank 0 copies it to the host and
  writes it, overlapping with the next chunk; at most one save is in
  flight;
* **§V-A prefetch** (``prefetch=True``) — the state carries batch t
  (``TrainState.minibatch``, built at ``init_state`` for step 0); a step
  forks the build of batch t + 1 onto a side CUDA stream before its
  forward (``core/pipeline.py``), the epoch of step t + 1 derived there,
  so the carry crosses epoch boundaries, and joins it before copying it
  into the carry's buffers. Captured, the build is a parallel branch of
  the graph. The losses are prefetch-off's bit for bit;
* **error feedback** — under a quantized ``TrainOptions.compress`` the
  state carries the accumulators (``TrainState.comm_ef``) from step to
  step and into checkpoints.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.checkpoint import (checkpoint_keys, checkpoint_path,
                                    latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core import fourd
from repro_torch.core import pipeline as PL
from repro_torch.obs.tracer import Tracer
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.tree import leaves, tree_map

CKPT_NAME = "state"          # full-TrainState checkpoints (vs bare "ckpt")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Host-side knobs of the runtime. Give the run length as
    ``total_steps`` OR as whole ``epochs`` (of ``plan.scfg.steps_per_epoch``
    steps each) — exactly one of the two."""

    total_steps: Optional[int] = None
    chunk_size: int = 8        # optimizer steps per chunk
    prefetch: bool = False     # §V-A: build batch t + 1 on a side stream
    eval_every: Optional[int] = 0   # steps between evals (0/None = never),
                               # rounded up to the enclosing chunk boundary
    target_acc: Optional[float] = None   # stop once an eval reaches this
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0        # steps between full-state saves (0 = only
                               # the final state), rounded up to the
                               # enclosing chunk boundary
    epochs: Optional[int] = None         # alternative to total_steps
    async_ckpt: bool = True    # overlap mid-run saves with the next chunk
    eval_every_epochs: Optional[int] = None   # eval cadence in epochs

    def __post_init__(self):
        if (self.total_steps is None) == (self.epochs is None):
            raise ValueError("give exactly one of total_steps / epochs")
        if (self.total_steps if self.total_steps is not None
                else self.epochs) < 0:
            raise ValueError("the run length must be >= 0")
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size={self.chunk_size}")
        if self.eval_every_epochs is not None:
            if self.eval_every_epochs <= 0:
                raise ValueError("eval_every_epochs must be a positive "
                                 "epoch count")
            if self.eval_every:
                raise ValueError("give the eval cadence as eval_every "
                                 "(steps) OR eval_every_epochs, not both")
        if self.target_acc is not None and not (self.eval_every
                                                or self.eval_every_epochs):
            raise ValueError("target_acc is only checked at eval "
                             "boundaries; set eval_every or "
                             "eval_every_epochs")


@dataclasses.dataclass
class RunLog:
    """What ``Trainer.run`` observed: the per-step losses in step order,
    the (step, accuracy) evals, whether the target stopped the run, and the
    final-state checkpoint path (None without a ckpt_dir)."""

    losses: List[float] = dataclasses.field(default_factory=list)
    evals: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    hit_target: bool = False
    final_ckpt: Optional[str] = None
    ms_per_step: float = 0.0     # train wall / steps, eval + blocking-ckpt
                                 # time excluded (the warm-up step and the
                                 # capture included, as the reference's
                                 # compile is)
    eval_s: float = 0.0          # total seconds spent in eval_fn
    ckpt_overlap_s: float = 0.0  # async-ckpt worker seconds hidden behind
                                 # training (io time minus the join waits)
    capture_s: float = 0.0       # seconds spent capturing the step (in
                                 # ms_per_step's wall too)
    replays: int = 0             # steps run as replays of the captured step


@dataclasses.dataclass
class _StepGraph:
    """One captured optimizer step: the graph, its loss (a buffer each
    replay rewrites) and the tensors it reads and writes, held so that no
    other tensor can take their places."""

    graph: "torch.cuda.CUDAGraph"
    loss: torch.Tensor
    buffers: List[torch.Tensor]

    def holds(self, buffers: List[torch.Tensor]) -> bool:
        return len(buffers) == len(self.buffers) and all(
            a is b for a, b in zip(buffers, self.buffers))


def _copy_into(dst, src) -> None:
    """Copy the leaves of ``src`` into those of ``dst`` (one structure),
    each distinct destination tensor once (planes share blocks)."""
    seen = set()
    for d, s in zip(leaves(dst), leaves(src)):
        if id(d) not in seen:
            seen.add(id(d))
            d.copy_(s)


class Trainer:
    """The runtime over a ``FourDPlan`` on one rank of its mesh: build
    once, then ``init_state`` / ``restore`` -> ``run`` -> ``save``, the same
    calls on every rank. The state holds the rank's shards. ``eval_fn``
    defaults to the plan's full-graph eval step. ``run`` and ``step``
    update the state's tensors in place."""

    def __init__(self, plan: fourd.FourDPlan, optimizer,
                 loop: TrainLoopConfig, *,
                 eval_fn: Optional[Callable] = None,
                 tracer: Optional[Tracer] = None):
        self.plan = plan
        self.optimizer = optimizer
        self.loop = loop
        self.tracer = tracer if tracer is not None else Tracer(enabled=True)
        self.steps_per_epoch = plan.scfg.steps_per_epoch
        self.total_steps = (loop.total_steps if loop.total_steps is not None
                            else loop.epochs * self.steps_per_epoch)
        self.eval_every = (loop.eval_every_epochs * self.steps_per_epoch
                           if loop.eval_every_epochs is not None
                           else (loop.eval_every or 0))
        self._sample_fn, self._loss_fn = PL.make_pipeline_fns(plan)
        self._side = PL.SideStream(plan.device)
        # a quantized wire carries error-feedback accumulators in the state
        self._uses_ef = self._loss_fn.engine.quantized
        self.eval_fn = eval_fn if eval_fn is not None \
            else fourd.make_eval_step(plan)
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None
        self._graph: Optional[_StepGraph] = None

    # -- state construction --------------------------------------------------

    def init_state(self, params, graph=None) -> TrainState:
        """A fresh state at step 0 over the rank's param shards: with the
        warm-up batch when prefetching (``graph`` is needed then) and zero
        EF accumulators when a wire is quantized."""
        if self.loop.prefetch and graph is None:
            raise ValueError("prefetch=True builds the warm-up batch at "
                             "init_state: pass graph=...")
        ef = fourd.make_ef(self.plan) if self._uses_ef else None
        state = init_train_state(params, self.optimizer.init(params), None,
                                 ef)
        if self.loop.prefetch:
            state.minibatch = self._sample_fn(graph, state.step, state.epoch)
        return state

    def save(self, state: TrainState, directory: Optional[str] = None,
             *, sync: bool = True,
             step: Optional[int] = None) -> Optional[str]:
        """Write the FULL state, unsharded, atomically; the filename carries
        the step. Every rank calls it; rank 0 writes. ``sync=True`` blocks
        until the file is on disk and returns its path; ``sync=False``
        snapshots the gathered state on the device and lets a worker
        thread copy and write it (returns None). The previous in-flight
        save is joined first either way."""
        directory = directory or self.loop.ckpt_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        self.join_saves()
        step = int(state.step) if step is None else step
        mesh = self.plan.mesh
        if sync:
            with self.tracer.span("ckpt"):
                full = self.plan.unshard(state)
                if mesh.rank == 0:
                    save_checkpoint(directory, step, full, name=CKPT_NAME)
                mesh.barrier()
            return checkpoint_path(directory, step, name=CKPT_NAME)
        snap = tree_map(lambda t: t.detach().clone(),
                        self.plan.unshard(state))
        if mesh.rank != 0:
            return None

        def work():
            t0 = time.perf_counter()
            try:
                save_checkpoint(directory, step, snap, name=CKPT_NAME)
            except BaseException as exc:       # surfaced at the next join
                self._save_exc = exc
            finally:
                self.tracer.record("ckpt_io", time.perf_counter() - t0)

        self._save_thread = threading.Thread(
            target=work, name="trainer-async-ckpt", daemon=True)
        self._save_thread.start()
        return None

    def join_saves(self) -> None:
        """Wait for the in-flight async save (if any) on every rank;
        re-raise its error."""
        if self._save_thread is not None:
            with self.tracer.span("ckpt_wait"):
                self._save_thread.join()
            self._save_thread = None
        self.plan.mesh.barrier()
        if self._save_exc is not None:
            exc, self._save_exc = self._save_exc, None
            raise exc

    def restore(self, example_state: TrainState,
                directory: Optional[str] = None,
                step: Optional[int] = None, *,
                graph=None) -> Optional[TrainState]:
        """Latest (or given-step) full-state checkpoint, restored into the
        structure, dtypes and devices of ``example_state`` (the rank's
        shards, sliced from the global leaves); None when there is none.
        Every rank calls it; the next ``run`` captures the step again over
        the restored state's buffers. The reference's rules for checkpoints
        written under other flags:

        * one without the ``.epoch`` leaf gets it from the step;
        * one without the prefetch carry, restored with prefetch on,
          rebuilds the warm-up batch from the restored (step, epoch) when
          ``graph`` is given (the carry is a pure function of them), and
          raises otherwise; one with the carry, restored with prefetch
          off, drops it;
        * one without EF accumulators, restored under a quantized wire,
          starts from zero ones (they only shift when the quantization
          error is corrected); one with them, restored without, drops
          them."""
        directory = directory or self.loop.ckpt_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        if step is None:
            step = latest_step(directory, name=CKPT_NAME)
            if step is None:
                return None
        keys = checkpoint_keys(directory, step, name=CKPT_NAME)
        heads = {k.split("::")[0] for k in keys}
        has_epoch = ".epoch" in heads
        rebuild_carry = self.loop.prefetch and ".minibatch" not in heads
        backfill_ef = self._uses_ef and ".comm_ef" not in heads
        if rebuild_carry and graph is None:
            raise ValueError(
                f"checkpoint step {step} in {directory} was written without "
                "the §V-A prefetch carry but this Trainer has prefetch=True: "
                "pass graph=... to restore() to rebuild the warm-up batch "
                "(the same bits: the carry is a pure function of (seed, "
                "epoch, step)), or resume with prefetch off")
        example = self.plan.unshard(example_state)
        example = dataclasses.replace(
            example, epoch=example.epoch if has_epoch else None,
            minibatch=None if rebuild_carry else example.minibatch,
            comm_ef=None if backfill_ef else example.comm_ef)
        state, _ = load_checkpoint(directory, step, example, name=CKPT_NAME)
        state = self.plan.shard(state)
        self._graph = None       # it holds the old state's buffers
        if not has_epoch:
            state = dataclasses.replace(
                state, epoch=self.plan.builder.epoch_of(state.step).to(
                    torch.int32))
        if backfill_ef:
            state = dataclasses.replace(state,
                                        comm_ef=fourd.make_ef(self.plan))
        if rebuild_carry:
            state = dataclasses.replace(state, minibatch=self._sample_fn(
                graph, state.step, state.epoch))
        return state

    # -- one step ------------------------------------------------------------

    def step(self, state: TrainState, graph) -> torch.Tensor:
        """One optimizer step in place; returns the loss, the mean over the
        DP groups (on the device). This is the body a CUDA graph captures:
        every update lands in the state's own tensors and nothing is read
        on the host. With prefetch it consumes the carried batch and copies
        batch t + 1, built on the side stream, into the carry; with error
        feedback it copies in the new accumulators."""
        mb = nxt = None
        if self.loop.prefetch:
            mb = state.minibatch
            # forked before the forward: batch t + 1 needs only the counter;
            # the span is the host's time in the fork
            with self.tracer.span("prefetch"):
                nxt = self._side.build(self._sample_fn, graph,
                                       state.step + 1)
        out = fourd.value_and_grad(self._loss_fn, state.params, graph,
                                   state.step, state.epoch, mb=mb,
                                   ef=state.comm_ef)
        if state.comm_ef is not None:
            _copy_into(state.comm_ef, out[2])
        self.optimizer.update(state.params, out[1], state.opt_state,
                              sumsq=self.plan.global_sumsq)
        if nxt is not None:
            self._side.join()
            _copy_into(state.minibatch, nxt)
        state.step.add_(1)
        state.epoch.copy_(self.plan.builder.epoch_of(state.step))
        return out[0]

    # -- the captured step ---------------------------------------------------

    def _captures(self) -> bool:
        """Whether ``run`` replays a captured step: on the card."""
        return self.plan.device.type == "cuda"

    def _p2p_options(self) -> List[str]:
        """The plan's options that make point-to-point hops
        (``batch_isend_irecv``) in the step: the rings, the quantized
        wires and the permute reshard, at g > 1 only (at g = 1 they make
        no call)."""
        if self.plan.mesh.shape["x"] == 1:
            return []
        opts, engine = self.plan.opts, self._loss_fn.engine
        found = []
        if opts.overlap_impl == "ring":
            found.append('overlap_impl="ring"')
        if engine.quantized:
            found.append(f"compress={opts.compress!r}")
        if opts.reshard_impl == "permute" and engine.cfg.use_residual:
            found.append('reshard_impl="permute"')
        return found

    @staticmethod
    def _buffers(state: TrainState, graph) -> List[torch.Tensor]:
        return leaves(state) + leaves(graph)

    def _capture(self, state: TrainState, graph) -> float:
        """Capture :meth:`step` over ``state`` and ``graph`` (runs
        nothing); returns the seconds it took. The async save's worker
        copies to the host, so it is joined first."""
        if self._save_thread is not None:
            self.join_saves()
        self._graph = None
        t0 = time.perf_counter()
        g = torch.cuda.CUDAGraph()
        with self.tracer.span("capture"):
            with torch.cuda.graph(g):
                loss = self.step(state, graph)
        self._graph = _StepGraph(g, loss, self._buffers(state, graph))
        return time.perf_counter() - t0

    def _run_chunk(self, state: TrainState, graph, n: int, last: bool,
                   log: RunLog) -> torch.Tensor:
        """``n`` steps on the card as replays of the captured step, the
        first one eagerly (then captured) when the graph does not hold this
        state; returns their (n,) losses on the device. ``last`` marks the
        run's final chunk, after whose last step nothing is captured."""
        losses = torch.empty((n,), dtype=torch.float32,
                             device=self.plan.device)
        buffers = self._buffers(state, graph)
        for i in range(n):
            if self._graph is not None and self._graph.holds(buffers):
                self._graph.graph.replay()
                losses[i].copy_(self._graph.loss)
                log.replays += 1
                continue
            losses[i].copy_(self.step(state, graph))      # the warm-up
            if not (last and i == n - 1):
                log.capture_s += self._capture(state, graph)
        return losses

    # -- the driver loop -----------------------------------------------------

    def run(self, state: TrainState, graph, *,
            report: Optional[Callable[[int, float, Optional[float]], None]]
            = None) -> Tuple[TrainState, RunLog]:
        """Run from ``state.step`` to the configured length (or the target
        accuracy) in chunks: replays of the captured step on the card, the
        eager step on the CPU. ``report(step, last_loss, acc)`` fires once
        per eval boundary — the SAME eval feeds the target check. A
        restored mid-run state continues its schedule. When ``ckpt_dir`` is
        set the final state is always persisted."""
        loop = self.loop
        total = self.total_steps
        captured = self._captures()
        p2p = self._p2p_options() if captured else []
        if p2p:
            raise NotImplementedError(
                f"{', '.join(p2p)} on a g = {self.plan.mesh.shape['x']} mesh "
                "makes point-to-point hops, which have not run inside a "
                "captured CUDA graph (ROADMAP: \"The captured step at "
                "g > 1\"); drive these options with the eager Trainer.step "
                "loop")
        log = RunLog()
        done = int(state.step)  # the host's mirror of the step from here on
        start_step = done
        eval_every = self.eval_every
        eval_mark = done // eval_every if eval_every else 0
        ckpt_mark = done // loop.ckpt_every if loop.ckpt_every else 0
        saved_at = None         # step of the newest (possibly async) save
        device_losses = []      # per-chunk device losses, read once at the end
        tr = self.tracer
        base = tr.totals()      # RunLog timing is the delta over this run
        t_run0 = time.perf_counter()

        while done < total and not log.hit_target:
            n = min(loop.chunk_size, total - done)
            with tr.span("chunk"):      # launch time (the card runs async)
                if captured:
                    device_losses.append(self._run_chunk(
                        state, graph, n, done + n == total, log))
                else:
                    device_losses.append(torch.stack(
                        [self.step(state, graph) for _ in range(n)]))
            done += n

            if eval_every and done // eval_every > eval_mark:
                eval_mark = done // eval_every
                with tr.span("eval"):
                    acc = float(self.eval_fn(state.params, graph))   # ONCE
                log.evals.append((done, acc))
                if report is not None:
                    report(done, float(device_losses[-1][-1]), acc)
                if loop.target_acc is not None and acc >= loop.target_acc:
                    log.hit_target = True
            if (loop.ckpt_dir and loop.ckpt_every
                    and done // loop.ckpt_every > ckpt_mark):
                ckpt_mark = done // loop.ckpt_every
                self.save(state, sync=not loop.async_ckpt, step=done)
                saved_at = done

        if loop.ckpt_dir:
            if saved_at == done:
                self.join_saves()
                log.final_ckpt = checkpoint_path(loop.ckpt_dir, done,
                                                 name=CKPT_NAME)
            else:
                log.final_ckpt = self.save(state, step=done)   # sync: exit
        else:
            self.join_saves()                           # surface any error

        if device_losses:
            log.losses = torch.cat(device_losses).cpu().tolist()
        # reading the losses waited for every step, so the wall time covers
        # the full train compute; subtract what blocked the driver for
        # other reasons (eval, sync-ckpt writes, async-ckpt joins)
        wall = time.perf_counter() - t_run0
        tot = tr.totals()

        def delta(name: str) -> float:
            return tot.get(name, 0.0) - base.get(name, 0.0)

        log.eval_s = delta("eval")
        log.ckpt_overlap_s = max(0.0, delta("ckpt_io") - delta("ckpt_wait"))
        steps_run = done - start_step
        if steps_run > 0:
            blocked = log.eval_s + delta("ckpt") + delta("ckpt_wait")
            log.ms_per_step = max(0.0, wall - blocked) * 1e3 / steps_run
        return state, log
