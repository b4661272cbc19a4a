from repro_torch.serving.engine import (kv_cache_memory_report,
                                        make_chunk_prefill_fn, make_serve_fns)
from repro_torch.serving.llm_engine import LLMEngine, RequestOutput
from repro_torch.serving.params import (FINISH_REASONS, EngineConfig,
                                        SamplingParams, default_detokenize)
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           pages_for_request)

__all__ = ["FINISH_REASONS", "ContinuousBatcher", "EngineConfig", "LLMEngine",
           "Request", "RequestOutput", "SamplingParams", "default_detokenize",
           "kv_cache_memory_report", "make_chunk_prefill_fn",
           "make_serve_fns", "pages_for_request"]
