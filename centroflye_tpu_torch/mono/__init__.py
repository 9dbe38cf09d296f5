"""cen6: monomer decomposition (`string_decomposer`, kernel K4 on the
card) and centroFlyeMono's monomer-alphabet assembly (`pipeline`)."""
