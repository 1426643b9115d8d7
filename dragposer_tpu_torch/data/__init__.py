"""Motion encoding."""
