"""Device ops of the port: top-k (host replicas and the fused CUDA kernel)
and ALS with its segment-accumulator CUDA kernels."""
