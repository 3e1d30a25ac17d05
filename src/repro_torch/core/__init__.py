from repro_torch.core.curriculum import (
    CurriculumSchedule,
    num_selected_batches,
    order_batches,
    selected_batch_ids,
)
from repro_torch.core.engine import (
    build_difficulty_fn,
    build_fim_warmup_fn,
    build_round_fn,
    build_sharded_compressed_round_fn,
    build_sharded_difficulty_fn,
    build_sharded_fim_warmup_fn,
    build_sharded_round_fn,
    client_sharding,
    replicated_sharding,
)
from repro_torch.core.fibecfed import ENGINES, ClientState, FibecFed
from repro_torch.core.fisher import (
    batch_fisher_scores,
    fim_diag,
    fim_momentum_update,
    per_sample_fisher_scores,
)
from repro_torch.core.gal import (
    adversarial_perturbation,
    aggregate_layer_scores,
    embedding_grad,
    layer_sensitivity_scores,
    lossless_rank_fraction,
    select_gal_layers,
)
from repro_torch.core.sparse import neuron_importance, select_neuron_masks
