"""Hand-written Hopper kernels of the port (built by `kernels.build`)."""
