"""Limb and RNS field arithmetic (counterpart of bgn_tpu.fieldcore)."""
