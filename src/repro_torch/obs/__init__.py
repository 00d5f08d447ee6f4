"""Zero-sync telemetry: metric registry, spans, Perfetto/Prometheus export
(copy of ``repro/obs``; the model and its rules are in
``docs/observability.md``)::

    from repro_torch import obs

    reg = obs.get_registry()              # process-wide default
    reg.counter("server.admitted").inc()
    with reg.span("trainer.step"):
        ...                               # host wall-clock; no device sync
    obs.write_chrome_trace(reg, "run.trace.jsonl")   # load in Perfetto
    print(obs.prometheus_text(reg))                  # /metrics payload

The port's ``Trainer`` and ``RolloutEngine`` take ``registry=``: ``None``
means the process default; ``obs.NULL`` turns their telemetry off.
``CostAccounted`` records a hot path's FLOPs and bytes as ``cost.*``
gauges once, at its first call (``obs/cost.py``: the reference reads them
from its compiled program).
"""
from repro_torch.obs import fleet
from repro_torch.obs.cost import (CostAccounted, compiled_cost,
                                  record_compiled_cost)
from repro_torch.obs.export import (SNAPSHOT_EVENT, prometheus_text,
                                    read_chrome_trace, write_chrome_trace)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.registry import (NULL, Counter, Gauge, Histogram,
                                      Registry, get_registry, set_registry)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "NULL",
           "get_registry", "set_registry", "write_chrome_trace",
           "read_chrome_trace", "prometheus_text", "SNAPSHOT_EVENT",
           "CostAccounted", "compiled_cost", "record_compiled_cost",
           "FlightRecorder", "fleet"]
