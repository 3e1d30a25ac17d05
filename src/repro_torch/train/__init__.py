from repro_torch.train.losses import make_logits_loss, make_loss_fn
