"""Plain PyTorch references the benchmark judges the program against.

Nothing here imports the program under test, ``jax`` or the JAX package.
"""
