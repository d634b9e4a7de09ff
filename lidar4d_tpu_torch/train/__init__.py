"""Training: losses, grouped Adam, EMA, the flow-loss cache and the train step."""
