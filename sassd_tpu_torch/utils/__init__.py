"""Small host-side helpers (logging, timing and tracing)."""
