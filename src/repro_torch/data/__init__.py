"""The synthetic token pipeline of LM training."""
