"""Hand-written CUDA kernels for the hot ops, each beside its plain
PyTorch version (taken for CPU tensors): :mod:`.topk`.

Sources live in ``reflow_tpu_torch/csrc/`` and are built at first use
(:mod:`._build`).
"""
