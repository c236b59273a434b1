"""Observability: the serving latency histogram (copy of
``repro/obs/metrics.py``). The tracer and the collective ledger are still
to be ported."""
