"""Command-line entry points: ``rdt-submit-torch`` (:mod:`.submit`, the port
of the reference's ``rdt-submit``; parity: bin/raydp-submit)."""
