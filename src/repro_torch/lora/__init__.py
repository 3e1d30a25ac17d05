from repro_torch.lora.lora import (
    gal_mask_tree,
    gather_adapter_slots,
    init_lora,
    lora_layer_index_tree,
    lora_num_logical_layers,
    lora_param_count,
    neuron_mask_tree,
    rank_mask_tree,
    stack_adapter_trees,
    zeros_like_lora,
)
