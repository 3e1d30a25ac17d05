from repro_torch.federated.async_agg import (
    AsyncAggConfig,
    AsyncScheduler,
    ClientUpdate,
    DoubleBufferedGlobal,
    MergeResult,
    adapted_buffer_size,
    adapted_step_count,
    cohort_weights,
    delta_weights,
    resolve_server_lr,
    staleness_weights,
)
from repro_torch.federated.baselines import BASELINES, make_runner, run_experiment
from repro_torch.federated.compress import (
    CompressionConfig,
    leaf_upload_breakdown,
    leaf_upload_bytes,
    topk_k,
)
from repro_torch.federated.hetero import (
    SCENARIOS,
    BoundScenario,
    ScenarioPreset,
    get_scenario,
    sync_round_time,
)
from repro_torch.federated.hierarchy import (
    HierarchyConfig,
    edge_assignments,
    edge_reduce,
    get_hierarchy,
)
from repro_torch.federated.prompt_tuning import FedPrompt
from repro_torch.federated.service import Federation, FederationService
from repro_torch.federated.store import ClientStore, InMemoryStore, OutOfCoreStore
