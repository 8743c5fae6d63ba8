"""WGAN-GP training on the port: the group step and the epoch loop."""
