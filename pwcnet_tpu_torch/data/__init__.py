"""Training data of the port (the procedural synthetic pairs)."""
