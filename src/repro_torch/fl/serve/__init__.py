"""Personalized-adapter serving plane, port of ``repro.fl.serve``.

Per-user adapter/LoRA trees live quantized at rest in stacked device
slabs (:mod:`.store`), ragged request flights batch by shape bucket over
an explicit user axis (:mod:`.engine`), and reproducible latency comes
from replaying Zipf/diurnal request traces on the virtual clock
(:mod:`.driver`). ``demo_plane``, ``personalized_trainables`` and the
``--adapters`` CLI train through the cohort engine and come with the
training slice.
"""
from repro_torch.fl.serve.driver import (RequestTrace, load_request_trace,
                                         replay, save_request_trace,
                                         zipf_request_trace)
from repro_torch.fl.serve.engine import (ServeConfig, ServeEngine,
                                         quant_head_logits,
                                         serve_sequential)
from repro_torch.fl.serve.store import (AdapterStore, quantize_at_rest,
                                        take_rows)

__all__ = [
    "AdapterStore", "RequestTrace", "ServeConfig", "ServeEngine",
    "load_request_trace", "quant_head_logits", "quantize_at_rest",
    "replay", "save_request_trace", "serve_sequential", "take_rows",
    "zipf_request_trace",
]
