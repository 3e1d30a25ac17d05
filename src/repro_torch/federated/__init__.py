from repro_torch.federated.baselines import BASELINES, make_runner, run_experiment
from repro_torch.federated.compress import (
    CompressionConfig,
    leaf_upload_breakdown,
    leaf_upload_bytes,
    topk_k,
)
from repro_torch.federated.prompt_tuning import FedPrompt
