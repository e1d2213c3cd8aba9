"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the program. Float32 throughout, with TF32 off;
no CUDA graphs and no kernels of the port. Each module works out the row
order, the batches and the state again from the inputs the benchmark hands
it, and follows the program's first training steps from the same initial
weights (``weights.py``, which both sides draw from).
"""
