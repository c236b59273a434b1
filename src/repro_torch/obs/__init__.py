"""Observability: the host phase tracer (``tracer``, the host half of
``repro/obs/tracer.py``), the serving latency histogram (``metrics``, a
copy of ``repro/obs/metrics.py``), the collective ledger (``comm``, the
counterpart of ``repro/obs/hlo.py``) and the benchmark record writer
(``bench``, a copy of ``repro/obs/bench.py``)."""
from repro_torch.obs.comm import (  # noqa: F401
    CommOp,
    CommReport,
    OverlapReport,
    assert_no_collectives,
    comm_report,
    overlap_report,
)
from repro_torch.obs.metrics import LatencyHistogram  # noqa: F401
from repro_torch.obs.tracer import (  # noqa: F401
    Tracer,
    get_tracer,
    phase,
    set_tracer,
)
