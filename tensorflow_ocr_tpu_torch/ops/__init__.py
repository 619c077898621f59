"""Compute ops: PixelLink decode and the CUDA connected-components kernel."""
