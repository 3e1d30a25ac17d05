"""Multi-tenant LoRA serving (port of ``repro.serve``)."""
from repro_torch.serve.engine import GenerationResult, ReferenceEngine, ServeEngine
from repro_torch.serve.requests import (
    Completion,
    Request,
    SamplingParams,
    batch_from_requests,
    make_prompt_batch,
    requests_from_batch,
)
from repro_torch.serve.scheduler import SlotScheduler
