"""Training: losses, optimiser, epoch loop and metrics."""
