"""Config grammar and local file streams."""
