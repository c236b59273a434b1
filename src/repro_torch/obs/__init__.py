"""Observability: the host phase tracer (``tracer``, the host half of
``repro/obs/tracer.py``) and the serving latency histogram (``metrics``, a
copy of ``repro/obs/metrics.py``). The collective ledger is still to be
ported."""
from repro_torch.obs.metrics import LatencyHistogram  # noqa: F401
from repro_torch.obs.tracer import (  # noqa: F401
    Tracer,
    get_tracer,
    phase,
    set_tracer,
)
