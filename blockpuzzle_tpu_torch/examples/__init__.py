"""Examples of the port's public surfaces (``quickstart``)."""
