"""tpumil_torch — the PyTorch/CUDA port of tpumil for NVIDIA Hopper (H100).

Module names follow ``tpumil/`` so each port sits beside its JAX
counterpart. The package imports ``torch`` and never ``jax`` or ``tpumil``;
hand-written Hopper kernels live under ``csrc/`` and are built at first use
(``utils/build.py``). Submodules are imported explicitly, never from here.
"""

__version__ = "0.1.0"
