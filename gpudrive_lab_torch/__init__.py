"""gpudrive_lab_torch — the PyTorch/CUDA port of gpudrive_lab_tpu.

The module layout mirrors ``gpudrive_lab_tpu`` so that each port module sits
at the same path as its JAX counterpart.  The port imports torch, numpy and
the standard library only; its hot kernels are hand-written CUDA under
``csrc/``, built at first use (see ``cuda_build.py``).
"""

__version__ = "0.1.0"
