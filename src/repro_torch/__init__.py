"""PyTorch/CUDA port of the fleet serve path (``repro`` is the JAX reference).

The package mirrors the reference's module layout (``repro_torch.fleet.sched``
is the counterpart of ``repro.fleet.sched``, and so on) and imports only
torch, numpy and scipy: never jax, never ``repro``. Host-side code (trace
synthesis, cost tables, quantization, request streams) is kept as numpy so
arrays built from the same seed are identical to the reference's; device
state and the control plane are torch tensors on an explicit ``device``.
Entry points default to ``device="cuda"`` and raise when no GPU is present.

The one kernel on this path, the quantized serve tick, is hand-written
CUDA C++ for ``sm_90a`` (``csrc/serve_tick.cu``), built with nvcc at first
use (``repro_torch.kernels.build``).
"""
