"""Small shared utilities (math helpers, pytree helpers)."""

from ray_tpu_torch.utils.math import cdiv, round_up_to_multiple  # noqa: F401
from ray_tpu_torch.utils.trees import (  # noqa: F401
    path_name,
    tree_map_with_path_names,
    tree_num_params,
    tree_size_bytes,
)
