"""The harness: traffic, weights, the traffic loop, the arithmetic of
operations and bytes, the trace reduction and the correctness check.
Nothing here imports JAX or the JAX package."""
