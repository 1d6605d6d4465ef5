"""Entry points of the port: ``serve`` (the adaptive-control serving
launcher) and ``train`` (the fault-tolerant training launcher)."""
