"""The fused train step of the port: losses, state and optimizer, step."""
