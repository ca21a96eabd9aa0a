"""Training runtime of the port: the trainer loop, checkpointing, fault
tolerance."""
