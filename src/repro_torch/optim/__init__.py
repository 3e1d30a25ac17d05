from repro_torch.optim.optimizers import (
    adamw_init,
    adamw_update,
    make_optimizer,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.schedule import linear_warmup_cosine
