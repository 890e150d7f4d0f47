"""Task setup shared by the drivers (port of efficientvlm_tpu/drivers/)."""
