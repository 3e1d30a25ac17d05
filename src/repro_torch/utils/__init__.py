from repro_torch.utils.tree import (
    flatten_dict,
    tree_add,
    tree_bytes,
    tree_l2_norm,
    tree_map_with_path_str,
    tree_scale,
    tree_size,
    tree_zeros_like,
    unflatten_dict,
)
