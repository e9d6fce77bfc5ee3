"""Package."""
