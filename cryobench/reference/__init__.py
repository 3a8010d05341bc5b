"""The plain reference of the benchmark's job kinds: plain PyTorch and
NumPy, importing nothing of the program or of JAX."""
