"""Serving layers of the port."""
