"""What the YAML loader needs of the distribution layer (its hints)."""
