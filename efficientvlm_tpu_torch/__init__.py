"""PyTorch/CUDA port of efficientvlm_tpu for NVIDIA Hopper.

Importing the package imports only torch and numpy; the CUDA kernels are
built and loaded at their first launch (kernels/build.py).
"""
