"""Developer tooling that ships with the package (no runtime dependencies)."""
