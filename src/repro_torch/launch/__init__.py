"""Entry points of the port: ``serve`` (the adaptive-control serving
launcher)."""
