"""PyTorch + CUDA port of the MDQT ultracold-plasma framework (H100)."""

__version__ = "0.1.0"
