"""Distribution beyond utils/dist.py (port of efficientvlm_tpu/parallel/):
the data-parallel certification worker. ZeRO-1, tensor / sequence /
pipeline parallelism and expert parallelism come with the second part of
ROADMAP A6."""
