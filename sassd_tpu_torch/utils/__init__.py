"""Small host-side helpers (logging)."""
