"""The program's models, one module per configuration ``model`` key:

- ``build(config, device)``: the port's module; ``preprocessor(config)``:
  the batch preprocessor its estimator takes (or None);
- the step's work as ``counts.py`` counts it: ``macs_per_row(config)``,
  ``dense_params(config)``, ``input_columns(config)`` and
  ``sparse_bytes(config, features, states)``, the bytes beyond the inputs
  and the dense parameters that a step's batch ``features`` needs;
- ``tiny(config)``: the configuration cut to a size the CPU tests run in
  seconds (changed in place)."""
