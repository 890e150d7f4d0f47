"""The offline CLIs (port of scripts/export_pruned.py, infer.py and
serve.py), each run as `python -m efficientvlm_tpu_torch.scripts.<name>`."""
