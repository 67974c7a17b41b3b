"""canonswap_torch — the CanonSwap generator in PyTorch, for NVIDIA Hopper.

A port of ``canonswap_tpu`` (JAX, the reference it is tested against): the
same networks under the reference checkpoint's ``state_dict`` keys, NCHW /
NCDHW inside, the JAX package's layouts at the public functions of
``runtime/core.py``.  The TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/``, built with nvcc at first use; each has a plain
PyTorch version that CPU tensors take.  Imports torch, never jax.
"""
