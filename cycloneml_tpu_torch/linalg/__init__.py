"""Local vector types."""
