"""Runtime support: :mod:`nw_tpu_torch.runtime.kernels` builds the CUDA
sources in ``nw_tpu_torch/csrc/`` with nvcc and binds them with ctypes."""
