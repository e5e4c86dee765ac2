"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``pi_search``: the index descent and the fused probe;
``pi_range``: range aggregation; ``bitonic_sort``: the batch sort;
``flash_attention``: the attention forward of the LM's prefill).
``ref`` holds independent oracles, ``ops`` the JAX package's wrappers.
"""
