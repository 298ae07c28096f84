"""Scripts run as modules (counterparts of scripts/)."""
