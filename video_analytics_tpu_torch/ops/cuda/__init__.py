"""Wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.  A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``."""
