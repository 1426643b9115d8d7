"""Training loops (the temporal predictor so far)."""
