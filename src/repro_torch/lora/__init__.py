from repro_torch.lora.lora import (
    gal_mask_tree,
    init_lora,
    lora_num_logical_layers,
    neuron_mask_tree,
    rank_mask_tree,
)
