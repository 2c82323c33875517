"""Training: losses, optimizer, steps and the fit loop."""
