"""Device ops of the port: top-k (host replicas and the fused CUDA kernel)."""
