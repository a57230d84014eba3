"""Kernel wrappers. Each module holds a kernel's wrapper, its plain PyTorch
version and its launch counter; the CUDA sources are in ../csrc and are
built by `build` at first use on the card."""
