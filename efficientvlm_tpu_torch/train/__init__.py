"""The retrieval pruning fine-tune (port of efficientvlm_tpu/train/)."""
