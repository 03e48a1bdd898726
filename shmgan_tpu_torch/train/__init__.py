"""Training in the port: losses, state and optimizer, the fused step, and the
epoch loop around it."""
