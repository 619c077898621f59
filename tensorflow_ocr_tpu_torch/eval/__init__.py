"""Detection metrics: matching to the ground truth and streaming P/R/F."""
