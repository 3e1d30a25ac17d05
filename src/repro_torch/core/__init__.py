from repro_torch.core.fibecfed import ClientState, FibecFed
