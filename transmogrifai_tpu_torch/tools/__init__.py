"""Measurement scripts of the port, run on a host with a CUDA card."""
