"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``pi_search``: the index descent and the fused probe).
"""
