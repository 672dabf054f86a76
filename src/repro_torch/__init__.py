"""PyTorch/CUDA port of the cross-layer fault-tolerant DL system.

Counterpart of the JAX package ``repro``, module for module (``repro_torch.
ft.protect_linear``, ``repro_torch.serve.engine.Engine``, ...).  It imports
torch and numpy, never jax, triton (at import time) or ``repro``.  Its
kernels are hand-written CUDA for Hopper (``repro_torch.kernels``), built
from the checkout's sources at first use.
"""
