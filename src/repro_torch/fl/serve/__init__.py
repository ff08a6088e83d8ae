"""Personalized-adapter serving plane, port of ``repro.fl.serve``.

Per-user adapter/LoRA trees live quantized at rest in stacked device
slabs (:mod:`.store`), ragged request flights batch by shape bucket over
an explicit user axis (:mod:`.engine`), and reproducible latency comes
from replaying Zipf/diurnal request traces on the virtual clock
(:mod:`.driver`). The store is fed by training: ``personalized_trainables``
trains one cohort wave into per-user trees, ``run_federated(serve_store=)``
refreshes it from the global model every round, and :mod:`.demo` wires a
small end-to-end plane from the training machinery (the ``--adapters``
mode of ``repro_torch.launch.serve``).
"""
from repro_torch.fl.serve.demo import DemoStreams, demo_plane, request_images
from repro_torch.fl.serve.driver import (RequestTrace, load_request_trace,
                                         replay, save_request_trace,
                                         zipf_request_trace)
from repro_torch.fl.serve.engine import (ServeConfig, ServeEngine,
                                         quant_head_logits,
                                         serve_sequential)
from repro_torch.fl.serve.store import (AdapterStore, personalized_trainables,
                                        quantize_at_rest, take_rows)

__all__ = [
    "AdapterStore", "DemoStreams", "RequestTrace", "ServeConfig",
    "ServeEngine", "demo_plane", "load_request_trace",
    "personalized_trainables", "quant_head_logits", "quantize_at_rest",
    "replay", "request_images", "save_request_trace", "serve_sequential",
    "take_rows", "zipf_request_trace",
]
