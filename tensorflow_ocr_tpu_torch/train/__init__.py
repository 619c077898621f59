"""Training: state, step, optimizer and EMA (port of ``train/``)."""
