from cotnet_tpu_torch.ops.local_agg import (
    extract_patches,
    local_aggregate,
    local_aggregate_dilated,
    local_aggregate_embed_gn,
    local_aggregate_mix,
    local_aggregate_mix_merge,
    local_aggregate_wt,
    out_size,
)

__all__ = ["extract_patches", "local_aggregate", "local_aggregate_dilated",
           "local_aggregate_embed_gn", "local_aggregate_mix",
           "local_aggregate_mix_merge", "local_aggregate_wt", "out_size"]
