"""Sketch kernels on torch tensors, their NumPy golden twins, and the
hand-written CUDA kernel (``cms_seq``) with its plain PyTorch version.

Plain tensor code runs on whatever device its tensors live on; the CUDA
kernel launches only for CUDA tensors (see ``ops/cms_seq.py``)."""
