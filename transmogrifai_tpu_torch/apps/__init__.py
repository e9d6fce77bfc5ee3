"""Applications built on the port."""
