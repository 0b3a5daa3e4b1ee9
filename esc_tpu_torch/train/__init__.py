"""Training and evaluation: data, optimizer, evaluation sweep, trainer."""
