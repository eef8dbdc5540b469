"""Compute kernels: tall-skinny QR and native (C++) host kernels."""
