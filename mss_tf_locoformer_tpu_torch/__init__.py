"""mss_tf_locoformer_tpu_torch — the PyTorch/CUDA port of TF-Locoformer MSS,
BS-Locoformer and the TF-Locoformer speech separator.

A second package beside the JAX one (``mss_tf_locoformer_tpu``), with the
same module names.  Plain tensor code is PyTorch; every Pallas kernel of the
JAX package is a CUDA C++ kernel for Hopper
(``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use and loaded
through ``ctypes``, see ``ops/cuda/__init__.py``).

This package imports ``torch`` and never ``jax``.  Importing it does no
work: submodules are imported where they are used.
"""

__version__ = "0.1.0"
