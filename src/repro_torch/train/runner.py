"""The chunked training runtime.

Counterpart of ``repro/train/runner.py``. ``Trainer`` runs a plan's steps
on this rank of the plan's mesh, in chunks of ``chunk_size``, each a
Python loop of steps (the reference's ``lax.scan``): sample + extract +
forward + loss (``fourd.make_loss_fn``), the backward through the
kernels' autograd rules and the mesh's collectives
(``fourd.value_and_grad``), the optimizer update of the rank's shards in
place, clipped by the global norm over the shards. Per-step losses stay on
the device until ``run()`` ends, so the host never waits on the card
between steps.

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
  snapshots it with ``.clone()`` on the device (queued on the current
  stream, so the next in-place update cannot reach it), and a worker
  thread of rank 0 copies it to the host and writes it, overlapping with
  the next chunk; at most one save is in flight.

§V-A prefetch is ROADMAP queue 1, "§V-A prefetch" (``prefetch=True``
raises). Capturing a chunk in a CUDA graph is later work.
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
from repro_torch.obs.tracer import Tracer
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.tree import tree_map

CKPT_NAME = "state"          # full-TrainState checkpoints (vs bare "ckpt")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Host-side knobs of the runtime. Give the run length as
    ``total_steps`` OR as whole ``epochs`` (of ``plan.scfg.steps_per_epoch``
    steps each) — exactly one of the two."""

    total_steps: Optional[int] = None
    chunk_size: int = 8        # optimizer steps per chunk
    prefetch: bool = False     # §V-A: not ported yet
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
                                 # time excluded
    eval_s: float = 0.0          # total seconds spent in eval_fn
    ckpt_overlap_s: float = 0.0  # async-ckpt worker seconds hidden behind
                                 # training (io time minus the join waits)


class Trainer:
    """The runtime over a ``FourDPlan`` on one rank of its mesh: build
    once, then ``init_state`` / ``restore`` -> ``run`` -> ``save``, the same
    calls on every rank. The state holds the rank's shards. ``eval_fn``
    defaults to the plan's full-graph eval step. ``run`` updates the
    state's tensors in place."""

    def __init__(self, plan: fourd.FourDPlan, optimizer,
                 loop: TrainLoopConfig, *,
                 eval_fn: Optional[Callable] = None,
                 tracer: Optional[Tracer] = None):
        if loop.prefetch:
            raise NotImplementedError(
                "prefetch=True (§V-A sampling overlap) is ROADMAP queue 1, "
                '"§V-A prefetch"')
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
        self._loss_fn = fourd.make_loss_fn(plan, train=True)
        self.eval_fn = eval_fn if eval_fn is not None \
            else fourd.make_eval_step(plan)
        self._save_thread: Optional[threading.Thread] = None
        self._save_exc: Optional[BaseException] = None

    # -- state construction --------------------------------------------------

    def init_state(self, params, graph=None) -> TrainState:
        """A fresh state at step 0 over the rank's param shards
        (``graph`` is the reference's signature; without prefetch it is
        not needed)."""
        del graph
        return init_train_state(params, self.optimizer.init(params))

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
        Every rank calls it. A checkpoint without the ``.epoch`` leaf gets
        it from the step; leaves the port's state does not hold (the
        reference's prefetch carry or error feedback) are left unread."""
        del graph
        directory = directory or self.loop.ckpt_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        if step is None:
            step = latest_step(directory, name=CKPT_NAME)
            if step is None:
                return None
        has_epoch = ".epoch" in checkpoint_keys(directory, step,
                                                name=CKPT_NAME)
        example = self.plan.unshard(example_state)
        if not has_epoch:
            example = dataclasses.replace(example, epoch=None)
        state, _ = load_checkpoint(directory, step, example, name=CKPT_NAME)
        state = self.plan.shard(state)
        if not has_epoch:
            state = dataclasses.replace(
                state, epoch=torch.tensor(int(state.step)
                                          // self.steps_per_epoch,
                                          dtype=torch.int32))
        return state

    # -- one step ------------------------------------------------------------

    def step(self, state: TrainState, graph) -> torch.Tensor:
        """One optimizer step in place; returns the loss, the mean over the
        DP groups (on the device)."""
        loss, grads = fourd.value_and_grad(self._loss_fn, state.params,
                                           graph, state.step, state.epoch)
        self.optimizer.update(state.params, grads, state.opt_state,
                              sumsq=self.plan.global_sumsq)
        state.step = state.step + 1
        state.epoch = state.step // self.steps_per_epoch
        return loss

    # -- the driver loop -----------------------------------------------------

    def run(self, state: TrainState, graph, *,
            report: Optional[Callable[[int, float, Optional[float]], None]]
            = None) -> Tuple[TrainState, RunLog]:
        """Run from ``state.step`` to the configured length (or the target
        accuracy) in chunks. ``report(step, last_loss, acc)`` fires once per
        eval boundary — the SAME eval feeds the target check. A restored
        mid-run state continues its schedule. When ``ckpt_dir`` is set the
        final state is always persisted."""
        loop = self.loop
        total = self.total_steps
        log = RunLog()
        done = int(state.step)
        start_step = done
        eval_every = self.eval_every
        eval_mark = done // eval_every if eval_every else 0
        ckpt_mark = done // loop.ckpt_every if loop.ckpt_every else 0
        saved_at = None         # step of the newest (possibly async) save
        device_losses = []      # per-step device scalars, read once at the end
        tr = self.tracer
        base = tr.totals()      # RunLog timing is the delta over this run
        t_run0 = time.perf_counter()

        while done < total and not log.hit_target:
            n = min(loop.chunk_size, total - done)
            with tr.span("chunk"):      # launch time (the card runs async)
                device_losses += [self.step(state, graph) for _ in range(n)]
            done += n

            if eval_every and done // eval_every > eval_mark:
                eval_mark = done // eval_every
                with tr.span("eval"):
                    acc = float(self.eval_fn(state.params, graph))   # ONCE
                log.evals.append((done, acc))
                if report is not None:
                    report(done, float(device_losses[-1]), acc)
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
                log.final_ckpt = self.save(state)       # sync: run() exit
        else:
            self.join_saves()                           # surface any error

        if device_losses:
            log.losses = torch.stack(device_losses).cpu().tolist()
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
