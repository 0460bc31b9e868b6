"""repro_torch.obs — observability for the coalition federation.

  :mod:`repro_torch.obs.metrics`   — per-round coalition-dynamics metrics
                                     (churn, size entropy, intra radius,
                                     barycenter drift), no extra sweep
                                     over W.
  :mod:`repro_torch.obs.ledger`    — the streaming run ledger: structured
                                     per-round / per-batch records and the
                                     sink registry (``jsonl`` | ``stdout``
                                     | ``in_memory``).
  :mod:`repro_torch.obs.timeline`  — simulated-time Chrome trace-event
                                     export (Perfetto).
  :mod:`repro_torch.obs.privacy`   — the DP client path's epsilon.
"""
from repro_torch.obs.ledger import (  # noqa: F401
    OBS_SCHEMA,
    ROUND,
    RUN_META,
    SERVE_BATCH,
    InMemorySink,
    JsonlSink,
    Sink,
    StdoutSink,
    TeeSink,
    available_sinks,
    coerce,
    make_sink,
    register_sink,
    tee,
)
