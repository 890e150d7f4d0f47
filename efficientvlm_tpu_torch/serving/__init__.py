"""Online serving (port of efficientvlm_tpu/serving/): the dynamic batcher
and the HTTP inference service."""

from .batching import DynamicBatcher, pad_items, pad_to_bucket
from .service import InferenceService, make_http_server, serve_forever_in_thread

__all__ = [
    "DynamicBatcher", "pad_items", "pad_to_bucket",
    "InferenceService", "make_http_server", "serve_forever_in_thread",
]
