"""Multi-rank (z-slab sharded) solves of the port."""
