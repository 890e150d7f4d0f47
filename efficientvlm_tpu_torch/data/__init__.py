"""Image preprocessing on the device (port of efficientvlm_tpu/data/)."""
