"""Distribution beyond utils/dist.py (port of efficientvlm_tpu/parallel/):
the data-parallel certification worker (multihost_check), ZeRO-1 (zero),
tensor parallelism and the sequence axis (sharding), the GPipe pipeline
(pipeline); expert parallelism lives with the MoE FFN (ops/moe.py)."""
