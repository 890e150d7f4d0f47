"""L0 gates and physical export (port of efficientvlm_tpu/pruning/)."""
