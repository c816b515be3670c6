"""The optimisation loop and the level objective."""
