"""Curve, pairing, BSGS and the CUDA kernel wrappers."""
