"""Training of the port: optimizer, step functions and the trainer loop."""
