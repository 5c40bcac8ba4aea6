"""Ops of the PyTorch port: plain tensor functions and kernel wrappers."""
