"""Device ops of the port: hashing/dedup, the fused wide stage and its
CUDA kernels, the frontier engines."""
