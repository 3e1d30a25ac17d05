from repro_torch.checkpoint.ckpt import (
    CorruptCheckpointError,
    clean_stale_tmp,
    latest_checkpoint,
    load_checkpoint,
    load_tree,
    save_checkpoint,
    save_tree,
)
from repro_torch.checkpoint.federation import (
    latest_run_checkpoint,
    load_run_checkpoint,
    restore_runner,
    save_run_checkpoint,
)
