"""cen6: monomer decomposition (`string_decomposer`, kernel K4 on the
card) and centroFlyeMono's monomer-alphabet assembly (`pipeline`)."""

from centroflye_tpu_torch.mono.monostring import MonoString, GAP  # noqa: F401
from centroflye_tpu_torch.mono.sd_parser import SDReport  # noqa: F401
