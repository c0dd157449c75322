"""``python -m nw_tpu_torch``: the byte-parity CLI on PyTorch and CUDA."""

from nw_tpu_torch.cli import console_main

if __name__ == "__main__":
    console_main()
