"""Optimizers, one module per configuration ``optimizer.name``:
``TORCH``, the ``torch.optim`` class the program is given; ``STATES``, the
state tensors it keeps per parameter (for the bytes a step moves); and
``Plain``, the reference's own implementation of the same update."""
