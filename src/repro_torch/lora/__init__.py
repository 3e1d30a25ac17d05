from repro_torch.lora.lora import (
    gal_mask_tree,
    gather_adapter_slots,
    init_lora,
    lora_num_logical_layers,
    neuron_mask_tree,
    rank_mask_tree,
    stack_adapter_trees,
)
