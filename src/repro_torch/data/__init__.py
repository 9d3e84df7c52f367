"""Input pipeline of the trainer (a copy of the reference's)."""
