from repro_torch.train.losses import (
    cls_loss,
    label_token_loss,
    lm_loss,
    make_label_token_loss,
    make_logits_loss,
    make_loss_fn,
    masked_mean_loss,
    per_sample_losses,
)
