"""Utilities of the port: tree helpers over its nested dicts (``tree``)."""
