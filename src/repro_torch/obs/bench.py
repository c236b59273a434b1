"""Persisted perf trajectory: the ``BENCH_<name>.json`` writer and differ.

A copy of ``repro/obs/bench.py`` (the port imports nothing of the JAX
package). A benchmark registers its entries (median/p10/p90 µs plus
derived metrics and optional collective bytes) and writes ONE
``BENCH_<name>.json`` stamped with the git SHA and the time;
:func:`compare_entries` diffs a fresh run against a baseline and flags
changes beyond a noise threshold.

Schema (version 1)::

    {"schema": 1, "name": "fig6", "git_sha": "...", "timestamp": "...",
     "config": {...},                      # benchmark-level knobs
     "entries": [{"name": "...", "median_us": ..., "p10_us": ...,
                  "p90_us": ..., "derived": "...", "comm_bytes": ...}]}
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1
BENCH_PREFIX = "BENCH_"


def git_sha(cwd: Optional[str] = None) -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


@dataclasses.dataclass
class BenchEntry:
    name: str
    median_us: float
    p10_us: Optional[float] = None
    p90_us: Optional[float] = None
    derived: str = ""
    comm_bytes: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "median_us": self.median_us}
        if self.p10_us is not None:
            d["p10_us"] = self.p10_us
        if self.p90_us is not None:
            d["p90_us"] = self.p90_us
        if self.derived:
            d["derived"] = self.derived
        if self.comm_bytes is not None:
            d["comm_bytes"] = self.comm_bytes
        return d


class BenchWriter:
    """Collects one benchmark's entries; writes ``BENCH_<name>.json``."""

    def __init__(self, name: str, config: Optional[Dict[str, Any]] = None,
                 repo_dir: Optional[str] = None):
        self.name = name
        self.config = dict(config or {})
        self.repo_dir = repo_dir
        self.entries: List[BenchEntry] = []

    def add(self, name: str, median_us: float, *,
            p10_us: Optional[float] = None, p90_us: Optional[float] = None,
            derived: str = "", comm_bytes: Optional[int] = None) -> None:
        self.entries.append(BenchEntry(
            name=name, median_us=float(median_us),
            p10_us=None if p10_us is None else float(p10_us),
            p90_us=None if p90_us is None else float(p90_us),
            derived=derived, comm_bytes=comm_bytes))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "name": self.name,
            "git_sha": git_sha(self.repo_dir),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "config": self.config,
            "entries": [e.to_dict() for e in self.entries],
        }

    def write(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{BENCH_PREFIX}{self.name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=False)
            f.write("\n")
        os.replace(tmp, path)
        return path


def load_bench(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    assert doc.get("schema") == SCHEMA_VERSION, (
        f"{path}: unknown BENCH schema {doc.get('schema')!r}")
    return doc


def compare_entries(current: Dict[str, Any], baseline: Dict[str, Any],
                    threshold: float = 0.30) -> List[Dict[str, Any]]:
    """Entry-by-entry diff of two BENCH docs (matched by entry name).

    A change counts only when the median moved by more than ``threshold``
    (relative) AND landed outside the baseline's [p10, p90] noise band
    (when the baseline recorded one). Returns one row per current entry:
    ``{name, baseline_us, current_us, ratio, status}`` with status in
    ``{"ok", "regression", "improvement", "unbaselined"}`` —
    ``unbaselined`` means the entry exists in the current run but the
    baseline has no (usable) median for it, so nothing was compared. These
    used to be dropped silently, which let a renamed metric dodge the gate.
    """
    base = {e["name"]: e for e in baseline.get("entries", [])}
    rows = []
    for ent in current.get("entries", []):
        b = base.get(ent["name"])
        if b is None or b.get("median_us") is None:
            rows.append({"name": ent["name"], "baseline_us": None,
                         "current_us": ent["median_us"], "ratio": None,
                         "status": "unbaselined"})
            continue
        if b["median_us"] == 0:
            # a zero baseline is meaningful for deterministic byte/count
            # metrics ("stays zero"): any growth is a regression outright
            grew = ent["median_us"] > 0
            rows.append({"name": ent["name"], "baseline_us": 0.0,
                         "current_us": ent["median_us"],
                         "ratio": float("inf") if grew else 1.0,
                         "status": "regression" if grew else "ok"})
            continue
        ratio = ent["median_us"] / b["median_us"]
        status = "ok"
        if ratio > 1.0 + threshold and ent["median_us"] > b.get(
                "p90_us", b["median_us"]) * (1.0 + threshold):
            status = "regression"
        elif ratio < 1.0 - threshold and ent["median_us"] < b.get(
                "p10_us", b["median_us"]) * (1.0 - threshold):
            status = "improvement"
        rows.append({"name": ent["name"],
                     "baseline_us": b["median_us"],
                     "current_us": ent["median_us"],
                     "ratio": ratio, "status": status})
    return rows
