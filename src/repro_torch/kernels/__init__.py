"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and
runs the plain version for tensors on the CPU; a failed build or launch
raises. ``KERNELS`` maps each wrapper to its source under ``csrc/``.
"""

KERNELS = {"serve_tick": "serve_tick.cu", "harvest_step": "harvest_step.cu"}
