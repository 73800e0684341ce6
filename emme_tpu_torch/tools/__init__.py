"""Measurement scripts of the port's CUDA kernels; each runs on one NVIDIA
GPU, from the repository root."""
