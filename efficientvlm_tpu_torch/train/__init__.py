"""The training steps and their optimizers (port of efficientvlm_tpu/train/)."""
