"""Host-side utilities: image resize."""
