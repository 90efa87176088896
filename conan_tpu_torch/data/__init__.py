"""Data loading of the port."""
