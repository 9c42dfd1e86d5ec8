"""Device probe and CUDA timing for the port."""
