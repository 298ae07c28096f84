"""Labs: measurements of single design questions (counterparts of exp/)."""
