"""Networks, checkpoints and weight loading."""
