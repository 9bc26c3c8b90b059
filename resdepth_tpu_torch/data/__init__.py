"""Inference batch assembly on the device."""
