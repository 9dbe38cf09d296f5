from centroflye_tpu_torch.ops.myers import (  # noqa: F401
    build_peq,
    myers_distance_batch,
    edit_distance_oracle,
)
