"""Serving utilities of the port."""
