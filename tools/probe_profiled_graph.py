#!/usr/bin/env python3
"""Does a CUDA-graph replay under ``torch.profiler`` crash after earlier
profiler sessions of the same process, and does it need the port's kernels
to crash?

    python3 tools/probe_profiled_graph.py            # every case, one card

Each case runs in a child process of its own, so that a crash ends only
that case. A case is ``prior:graph``:

* ``prior`` — what ran before: ``none``; ``matmul`` or ``port``, four
  profiler sessions (three of CUDA activity, as ``chip_smoke.py``'s
  kernel timings take them, then one of CPU and CUDA activity) over
  ``torch.matmul``, or over the port's ``hash_keys`` and ``keep_mask``
  kernels, launched through ``ctypes`` from the port's library;
  ``serve``, ``chip_smoke.py``'s serving phase on a 65,536-vertex
  graph, its profiled stream included; ``serve-unprofiled``, the same
  without the profiled stream;
* ``graph`` — the CUDA graph then captured and replayed 8 times under a
  profiler session (CPU and CUDA activity, as ``chip_smoke.py`` profiles
  a training chunk): ``matmul`` (four ``torch.matmul``), ``port`` (the
  two counter kernels) or ``step`` (the port's training step at the
  paper's width on the same graph, batch 4096, prefetch on, captured and
  replayed by ``Trainer.run``; ``stepnp`` the same with prefetch off, as
  ``chip_smoke.py``'s profiled chunk runs); or ``smoke``, ``chip_smoke.py``'s
  training phase on the same graph up to its profiled chunk of replays
  (the sequence that crashed when it followed the serving phase), and
  ``smoke-matmul``, the same with a ``matmul`` graph captured and
  replayed under the profiler just before that chunk, and
  ``smoke-old-matmul`` / ``smoke-old-port``, with a ``matmul`` or
  ``port`` graph captured before the phase's 48-step run (before the
  step's graph) and replayed under the profiler there; ``smoke-no8``,
  ``smoke-nospread`` and ``smoke-bare``, the phase with its 8-step run,
  its two spread runs, or all three run as eager steps instead (no
  captured graph made and freed before the profiled chunk; the phase's
  checks see the same losses). ``traced-freed`` captures the training
  step's graph (as ``step``), replays it under a first profiler session
  whose trace is kept alive, destroys that graph and captures a second
  one, and replays that under a second session: a graph destroyed
  between two profiler sessions while kineto still holds the first
  one's activity records. A ``-freed``
  suffix (``matmul-freed``, ``port-freed``, ``step-freed``) captures a
  second graph of the kind after the first and frees it before the
  first's profiled replays, as ``chip_smoke.py``'s training phase freed
  its spread runs' graphs before its profiled chunk until that order
  was found to crash. ``step-eval`` runs one full-graph evaluation (the
  sparse CSR product) between the step's run and its profiled replays,
  as ``chip_smoke.py``'s training phase does; ``step-freed-eval`` does
  both, the evaluation first; ``smoke-noeval`` is ``smoke`` with that
  evaluation left out.

``--cases prior:graph ...`` runs only those cases, each ``--runs`` times
(once by default); by default each of ``matmul``, ``port`` and ``step``
runs after each prior, then the four ``smoke`` cases after ``serve``.

Every case that crashes runs again under each of kineto's CUPTI switches
(``TEARDOWN_CUPTI=0``, ``DISABLE_CUPTI_LAZY_REINIT=1``), unless
``--no-switches``. The script prints
the card's name and power limit, one line per case (the child's exit
code, and the kernels its replay trace held), the CUPTI-related names
found in torch's libraries, and one JSON object, also written to the
file ``--out`` names, if it names one.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRIORS = ("none", "matmul", "port", "serve", "serve-unprofiled")
GRAPHS = ("matmul", "port", "step", "stepnp")
SMOKE_CASES = ("serve:smoke", "serve:smoke-matmul", "serve:smoke-old-matmul",
               "serve:smoke-old-port")
VERTICES = 65536
SWITCHES = ({"TEARDOWN_CUPTI": "0"}, {"DISABLE_CUPTI_LAZY_REINIT": "1"})
REPLAYS = 8


def child(prior: str, kind: str) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import use_full_f32_matmul
    from repro_torch.kernels import counter_rng as crng
    use_full_f32_matmul()                # as chip_smoke.py runs
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    key = torch.full((), 12345, dtype=torch.int64, device=dev)

    def port_kernels():
        crng.hash_keys(key, 1 << 20)
        crng.keep_mask(key, 4096, 256, 0.3)

    if prior.startswith("serve"):
        _serve(torch, profiled=prior == "serve")
    prior_fn = {"matmul": lambda: a @ a, "port": port_kernels}.get(prior)
    if prior_fn is not None:
        prior_fn()
        torch.cuda.synchronize()
        for i in range(4):
            with profile(activities=[ProfilerActivity.CUDA] if i < 3 else
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA]
                         ) as prof:
                for _ in range(20):
                    prior_fn()
                torch.cuda.synchronize()
            prof.key_averages()

    if kind.startswith("smoke"):
        return _smoke_training(torch, kind, lambda k: _replays(
            torch, dev, k, a, port_kernels))
    if kind == "traced-freed":
        return _traced_freed(torch, dev)
    base, _, suffix = kind.partition("-")
    replay = _replays(torch, dev, base, a, port_kernels,
                      eval_between="eval" in suffix)
    if "freed" in suffix:        # another graph of the kind, then freed
        _replays(torch, dev, base, a, port_kernels)
        gc.collect()
        torch.cuda.synchronize()
    print(json.dumps({"device_events": _profile_replays(torch, replay)}),
          flush=True)
    return 0


def _replays(torch, dev, kind, a, port_kernels, eval_between=False):
    """A captured graph of ``kind``; returns a call that replays it
    ``REPLAYS`` times (a step's graph after a full-graph evaluation, with
    ``eval_between``)."""
    if kind in ("step", "stepnp"):
        return _step_replays(torch, dev, eval_between,
                             prefetch=kind == "step")
    body = {"matmul": lambda: [a @ a for _ in range(4)],
            "port": port_kernels}[kind]
    side = torch.cuda.Stream()              # warm up off the main stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()

    def replay():
        for _ in range(REPLAYS):
            graph.replay()
    return replay


def _dataset():
    from repro_torch.graphs import get_dataset
    return get_dataset("ogbn-products", scale_vertices=VERTICES)


def _serve(torch, profiled: bool) -> None:
    """``chip_smoke.py``'s serving phase at the paper's width."""
    import dataclasses

    import numpy as np

    import chip_smoke
    from repro_torch.configs.gcn_paper import paper_model
    if not profiled:
        chip_smoke.profile_stream = lambda *a: None
    cfg = dataclasses.replace(paper_model("ogbn-products"),
                              elementwise_impl="cuda")
    chip_smoke.phase_serve(torch, np, _dataset(), cfg, 400)


class _Done(Exception):
    pass


def _profile_replays(torch, replay, keep: bool = False):
    """``replay()`` under a profiler session (CPU and CUDA activity);
    returns the trace's device events (with ``keep``, with the profiler
    object, whose records then outlive the session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))
    return (n, prof) if keep else n


def _smoke_training(torch, kind: str, make_replays) -> int:
    """``chip_smoke.py``'s phase 5 up to its profiled chunk of replays
    (what follows it is cut off). ``smoke-matmul`` profiles a ``matmul``
    graph captured where that chunk starts; ``smoke-old-matmul`` and
    ``smoke-old-port`` one captured before the phase's 48-step run (so
    before the step's graph), profiled there."""
    import numpy as np

    import chip_smoke
    log = chip_smoke.log
    old = kind.startswith("smoke-old-")
    held = {}

    def hook(msg):
        log(msg)
        if old and msg.startswith("[train] 8 steps, plain"):
            held["replay"] = make_replays(kind.rpartition("-")[2])
            print("[probe] graph captured before the 48-step run",
                  flush=True)
        if msg.startswith("[train] full-graph accuracy") and (
                old or kind == "smoke-matmul"):
            replay = held["replay"] if old else make_replays("matmul")
            n = _profile_replays(torch, replay)
            print(f"[probe] {kind[6:]} graph profiled there: {n} device "
                  "events", flush=True)

    def stop(*a, **k):
        raise _Done

    chip_smoke.log = hook
    chip_smoke.phase_train_nccl = stop
    # the phase's Trainer.run calls: the 8-step run (8 steps), the 48-step
    # run (the first of 48), two spread runs (the later ones of 48) and the
    # profiled chunk (56); a cut call runs eagerly
    cut = {"smoke-no8": {"8-step"}, "smoke-nospread": {"spread"},
           "smoke-bare": {"8-step", "spread"}}.get(kind, set())
    if cut:
        from repro_torch.train import Trainer
        run, runs48 = Trainer.run, []

        def eager_or_captured(self, state, graph, **kw):
            what = "8-step" if self.total_steps == chip_smoke.CHUNK else None
            if self.total_steps == chip_smoke.TRAIN_STEPS:
                runs48.append(1)
                what = "spread" if len(runs48) > 1 else None
            if what not in cut:
                return run(self, state, graph, **kw)
            self._captures = lambda: False
            state, lg = run(self, state, graph, **kw)
            lg.replays = len(lg.losses) - 1    # as a captured run reports
            print(f"[probe] the {what} run ran eagerly", flush=True)
            return state, lg
        Trainer.run = eager_or_captured
    if kind == "smoke-noeval":
        from repro_torch.core import fourd
        fourd.make_eval_step = lambda plan: (lambda params, graph: 0.0)
    plan, graph, pg = chip_smoke.train_setup(torch, _dataset(),
                                             torch.device("cuda"))
    try:
        chip_smoke.phase_train(torch, np, plan, graph, pg)
    except _Done:
        pass
    print("[probe] the profiled chunk of replays ran", flush=True)
    print(json.dumps({"device_events": None}), flush=True)
    return 0


def _traced_freed(torch, dev) -> int:
    """A step graph replayed under a profiler session whose trace stays
    alive; that graph destroyed; a second step graph captured and replayed
    under a second session."""
    replay = _step_replays(torch, dev)
    first = _profile_replays(torch, replay, keep=True)
    del replay
    gc.collect()
    torch.cuda.synchronize()
    print("[probe] the first step graph destroyed, its trace held",
          flush=True)
    n = _profile_replays(torch, _step_replays(torch, dev))
    print(json.dumps({"device_events": [first[0], n]}), flush=True)
    del first
    return 0


def _step_replays(torch, dev, eval_between=False, prefetch=True):
    """A captured training step (``Trainer.run``: a warm-up step, a capture
    and replays), then with ``eval_between`` one full-graph evaluation;
    returns a call that replays ``REPLAYS`` more steps."""
    from repro_torch.configs.gcn_paper import paper_model
    from repro_torch.core import fourd
    from repro_torch.core import gcn_model as M
    from repro_torch.graphs import build_partitioned_graph
    from repro_torch.optim import AdamW, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainLoopConfig

    pg = build_partitioned_graph(_dataset(), g=1)
    cfg = paper_model("ogbn-products")
    opts = fourd.TrainOptions(spmm_impl="ell", fused_elementwise=True,
                              extract_impl="cuda", dropout=0.3,
                              ell_tile=128, ell_slots=32)
    plan = fourd.build_plan(pg, cfg, fourd.make_mesh_4d(1, 1, dev),
                            batch=4096, opts=opts)
    graph = plan.shard_graph(pg)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    tr = Trainer(plan, AdamW(lr=linear_warmup_cosine(5e-3, 4, 64),
                             weight_decay=1e-4, grad_clip=1.0),
                 TrainLoopConfig(total_steps=8, chunk_size=8,
                                 prefetch=prefetch),
                 eval_fn=lambda p, g: 0.0)
    state = tr.init_state(params, graph)
    tr.run(state, graph)
    if eval_between:
        print(f"[probe] full-graph accuracy "
              f"{float(fourd.make_eval_step(plan)(state.params, graph)):.6f}"
              " between the run and the profiled replays", flush=True)

    def replay():
        tr.total_steps += REPLAYS
        _, log = tr.run(state, graph)
        assert log.replays == REPLAYS
    return replay


def cupti_names(torch_dir: Path) -> list:
    """The upper-case names with CUPTI in them in torch's libraries (the
    environment switches kineto reads among them): each ``CUPTI`` found,
    widened over the name characters around it."""
    name = re.compile(rb"[A-Z0-9_]")
    found = set()
    for lib in sorted((torch_dir / "lib").glob("*.so*")):
        if "torch" not in lib.name and "kineto" not in lib.name:
            continue
        data = lib.read_bytes()
        at = data.find(b"CUPTI")
        while at >= 0:
            lo, hi = at, at + 5
            while lo > 0 and hi - lo < 64 and name.match(data, lo - 1):
                lo -= 1
            while hi < len(data) and hi - lo < 64 and name.match(data, hi):
                hi += 1
            found.add(data[lo:hi].decode())
            at = data.find(b"CUPTI", hi)
    return sorted(found)


def run_case(prior: str, kind: str, env: dict) -> dict:
    t0 = time.monotonic()
    try:
        p = subprocess.run([sys.executable, "-X", "faulthandler", __file__,
                            "--case",
                            f"{prior}:{kind}"], capture_output=True,
                           text=True, timeout=300,
                           env=dict(os.environ, **env))
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = "timeout", exc.stdout or "", exc.stderr or ""
    last = (out.strip().splitlines() or [""])[-1]
    res = {"prior": prior, "graph": kind, "env": env, "rc": rc,
           "seconds": round(time.monotonic() - t0, 1),
           "device_events": (json.loads(last)["device_events"]
                             if last.startswith("{") else None)}
    res["stdout_tail"] = out[-600:]
    if rc != 0:
        res["stderr_tail"] = err[-1500:]
    print(f"[probe] prior {prior:6s} graph {kind:6s} env {env or '-'}: "
          f"rc {rc}, {res['device_events']} device events in the replay "
          f"trace, {res['seconds']} s", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", default=None, help="prior:graph (child)")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="prior:graph ... (default: all)")
    ap.add_argument("--runs", type=int, default=1,
                    help="runs of each case")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    ap.add_argument("--no-switches", action="store_true",
                    help="do not rerun crashed cases under kineto's "
                         "CUPTI switches")
    args = ap.parse_args()
    if args.case is not None:
        return child(*args.case.split(":"))

    import torch
    if not torch.cuda.is_available():
        print("probe_profiled_graph: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build()                       # once, for every child
    print(f"[probe] kernels built in {time.monotonic() - t0:.1f} s",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = cupti_names(Path(torch.__file__).parent)
    print(f"[probe] torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"CUPTI names in its libraries: {names}", flush=True)
    picked = args.cases if args.cases is not None else [
        f"{p}:{g}" for g in GRAPHS for p in PRIORS] + list(SMOKE_CASES)
    cases = [run_case(*c.split(":"), {}) for c in picked
             for _ in range(args.runs)]
    for c in [c for c in cases if c["rc"] != 0 and not args.no_switches]:
        cases += [run_case(c["prior"], c["graph"], env) for env in SWITCHES]
    crashes: dict = {}
    for c in cases:
        tag = f"{c['prior']}:{c['graph']} {c['env'] or ''}".strip()
        n, bad = crashes.get(tag, (0, 0))
        crashes[tag] = (n + 1, bad + (c["rc"] != 0))
    for tag, (n, bad) in crashes.items():
        print(f"[probe] {tag}: {bad} of {n} runs failed", flush=True)
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "cupti_names": names,
           "cases": cases}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "cupti_names"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
