"""Algorithm engines of the port (one module per program family)."""
