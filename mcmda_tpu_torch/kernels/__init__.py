"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (see ``fused_conv.py``); ``build.py`` compiles and loads them."""
