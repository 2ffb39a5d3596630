"""Named system configurations."""
